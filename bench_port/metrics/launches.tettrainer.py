"""``launches.tettrainer``: ``launches.trainer``'s reader in the tet-mesh
trainer cell: enqueuing runtime calls inside the port's
``dmesh2/train_step`` ranges per iteration; None where the port opens no
such range."""

from bench_port.harness import load_module


def read(run):
    return load_module("metrics", "launches.trainer").read(run)
