"""Set-up: from the start of the process to the window's start
(imports, the CUDA context, weights, data, warm-up)."""


def read(run):
    return run.setup_s
