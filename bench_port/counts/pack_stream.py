"""Work of ``pack_stream`` at the cell's inputs (``bench_port.counting.record_pack``)."""

from bench_port.counting import record_pack

# The kernel's name in the device trace.
PATTERN = r"pack_stream_kernel"


def count(run):
    return record_pack(run)
