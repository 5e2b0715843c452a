"""``idle_pct.tettrainer``: ``idle_pct.trainer`` in the tet-mesh trainer
cell: percent of the traced window in which the device ran no
operation."""

from bench_port import readers


def read(run):
    return readers.idle_pct(run)
