"""``pack_stream_roofline``: percent of ``pack_stream``'s roofline (bytes-
bound)."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "pack_stream")
