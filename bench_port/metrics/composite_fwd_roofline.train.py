"""``composite_fwd_roofline.train``: percent of ``composite_fwd``'s
roofline in the training step."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_fwd")
