"""``setup_s``: process start to the window's start, on the host clock —
imports, the CUDA context, loading or building the kernels, making the
inputs, packing, compiling and warming every shape the traffic uses."""


def read(run):
    return run.setup_s
