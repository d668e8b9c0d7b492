"""Seconds of set-up in the program's ``kernels_load`` span: building
(nvcc, where a library is not built yet) and loading the kernel
libraries."""

from benchmark import program_spans


def read(ctx):
    return program_spans.setup_seconds("kernels_load")
