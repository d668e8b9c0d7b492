"""The demo room of configuration ``demo`` (``demo.py`` beside this file),
unchanged: the same scene and camera, which ``demo_bvh`` renders with the
library's default traversal. The reference decides each closest hit with
its own world-space BVH, whatever walk the program runs."""

from __future__ import annotations

import benchmark.configs.demo as _demo

description = _demo.description
camera = _demo.camera
