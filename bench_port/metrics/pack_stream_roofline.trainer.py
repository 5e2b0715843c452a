"""``pack_stream_roofline.trainer``: percent of ``pack_stream``'s roofline
(bytes-bound) in the multi-view step."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "pack_stream")
