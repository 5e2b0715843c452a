"""``pack_stream_roofline.tettrainer``: percent of ``pack_stream``'s
roofline (bytes-bound) in the tet-mesh trainer step."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "pack_stream")
