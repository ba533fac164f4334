"""Share of the RLE1 split's input that its wide path copied, in %: the
``wide_bytes`` of the program's ``split`` spans (``rle1.encode_blocks``)
over their ``bytes``, of every call whose ``compress`` span began in the
window.  None where the program records no spans or its split spans carry
no ``wide_bytes`` (a split without the wide path)."""


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
    split = [s for s in _calls_in_window(probe)
             if s["name"] == "split" and "wide_bytes" in s]
    total = sum(s["bytes"] for s in split)
    if not total:
        return None
    return 100.0 * sum(s["wide_bytes"] for s in split) / total
