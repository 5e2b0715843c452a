"""``blended_pct``: percent of the binned entries that lie in some tile's
contributing prefix (the entries the blend and the backward use), from the
port's ``counters()["entries"]``: 100 x ``blended`` / ``binned``, summed
over the steps whose capacity check ran in the process (the warm-up's and
the traced ones). None where the port keeps no such counters."""


def read(run):
    from dmesh2_renderer_tpu_torch.utils.profiling import counters

    entries = counters().get("entries")
    if not entries or not entries.get("binned"):
        return None
    return 100.0 * entries["blended"] / entries["binned"]
