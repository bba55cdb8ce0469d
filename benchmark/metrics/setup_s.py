"""setup_s: seconds from the process's start to the window's: imports,
CUDA init, the kernels and native library loaded (built on a first run),
the inputs made from the seed, the program's set-up work on them and one
warm-up operation."""


def read(run):
    return run.setup_s
