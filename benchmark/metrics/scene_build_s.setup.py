"""Seconds of set-up in the program's ``scene_build`` span: compiling
the scene on the host (BLAS, Woop tables) and uploading it."""

from benchmark import program_spans


def read(ctx):
    return program_spans.setup_seconds("scene_build")
