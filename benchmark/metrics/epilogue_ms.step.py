"""Host ms a step in the program's ``trace_epilogue`` span: ops/intersect.py
``lite_epilogue``, the no-grad hit record of the lite kernel's winners
(kernel 3 on the grid) that the standard loop's finder builds before the
recompute. The span and its arithmetic are ``epilogue_ms.frame``'s, read
over the window's steps; a program without the span reads None."""

from pathlib import Path

from benchmark import harness

_frame = harness.load_module(Path(__file__).with_name("epilogue_ms.frame.py"))
COUNTERS = _frame.COUNTERS
read = _frame.read
