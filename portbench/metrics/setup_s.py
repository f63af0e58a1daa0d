"""setup_s: from the process's start to the window's: CUDA init, the
kernels built or loaded, the corpus made, one warm fit at full size."""


def read(run):
    return run.setup_s
