"""``composite_fwd_roofline.forward``: percent of ``composite_fwd``'s
roofline in forward-only frames."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_fwd")
