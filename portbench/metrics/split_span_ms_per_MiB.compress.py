"""Host milliseconds of the RLE1 split a MiB compressed, read from the
program's own spans (``bzip2_tpu_torch.tracing.span``): the ``split``
spans (``rle1.encode_blocks``) over the bytes they record, of every call
whose ``compress`` span began in the window.  The inside twin of
``split_ms_per_MiB.compress``.  None where the program records no spans."""


def install(probe):
    from bzip2_tpu_torch import tracing
    if hasattr(tracing, "enable_spans"):
        tracing.enable_spans(True)


def start(probe):
    install(probe)          # empties the store after the warm-up


def _calls_in_window(probe):
    """The program's spans of the calls whose ``compress`` span began in
    the window (the store is read once and kept in the probe)."""
    from bzip2_tpu_torch import tracing
    if "spans" not in probe.counters:
        probe.counters["spans"] = (tracing.spans()
                                   if hasattr(tracing, "spans") else [])
    spans = probe.counters["spans"]
    calls = {s["call"] for s in spans if s["name"] == "compress"
             and s["parent"] is None and probe.in_window(s["t0_ns"])}
    return [s for s in spans if s["call"] in calls]


def read(probe):
    split = [s for s in _calls_in_window(probe) if s["name"] == "split"]
    mib = sum(s["bytes"] for s in split) / 2 ** 20
    if not mib:
        return None
    return sum(s["t1_ns"] - s["t0_ns"] for s in split) / 1e6 / mib
