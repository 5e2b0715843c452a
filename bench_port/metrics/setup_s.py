"""``setup_s``: seconds from the process's start to the first measured
iteration (imports, the kernels' build or load, the scene, the warm-up)."""


def read(run):
    return run.setup_s
