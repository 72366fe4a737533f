"""Seconds from the process's start until the window opens: imports, the
CUDA context, the world of ranks, the weights, the corpus, the anchor bank
and the warm-up of every stream shape (and, in a fresh checkout, the build
of the kernel library)."""


def read(run):
    return run["setup_s"]
