"""``composite_bwd_roofline.tettrainer``: percent of ``composite_bwd``'s
roofline in the tet-mesh trainer step (one launch over every view)."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_bwd")
