"""``composite_fwd_roofline.trainer``: percent of ``composite_fwd``'s
roofline in the multi-view step (one launch over every view)."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_fwd")
