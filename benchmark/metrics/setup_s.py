"""setup_s: seconds from the process's start to the window's start
(imports, CUDA start-up, a checkout's first kernel build, inputs made
from the seed, warm-up).  Host clock."""


def read(run):
    return run.setup_s
