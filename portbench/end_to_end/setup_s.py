"""Seconds from the process's start to the window's start: imports, the CUDA
context, the kernel libraries, the program's mesh and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
