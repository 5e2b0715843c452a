"""``backward_ms.train``: mean host-clock milliseconds of
``loss.backward()``, from a synchronise to a synchronise, per traced
step."""

from bench_port import readers


def read(run):
    return readers.span_ms(run, "backward")
