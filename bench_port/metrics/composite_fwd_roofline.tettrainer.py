"""``composite_fwd_roofline.tettrainer``: percent of ``composite_fwd``'s
roofline in the tet-mesh trainer step (one launch over every view)."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_fwd")
