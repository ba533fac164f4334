"""Share of the traced window in which the card is idle while a device
worker of the engine stages a batch or launches its work: instants with
no kernel or copy on the card (the window less ``probe.busy()``) at which
some worker thread is inside a ``batch`` span of the program
(``bzip2_tpu_torch.tracing.span``) and, on that thread, under no ``wait``
span (blocked on the card) and no ``heap`` span (the host's Huffman
heap): packing, copies in, launches.  Spans of the calls
whose ``compress`` span began in the window, clipped to it.  None where
the program records no spans or the run has no device trace."""


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
    from portbench.trace import clip, intersect, subtract, total, union

    w = probe.window_s()
    spans = _calls_in_window(probe)
    if not w or not probe.device or not spans:
        return None
    lo, hi = probe.window_ns
    by_tid: dict = {}
    for s in spans:
        if s["name"] in ("batch", "wait", "heap"):
            part = "batch" if s["name"] == "batch" else "blocked"
            by_tid.setdefault(s["tid"], {"batch": [], "blocked": []})[
                part].append([s["t0_ns"], s["t1_ns"]])
    staging: list = []
    for iv in by_tid.values():
        staging += subtract(union(iv["batch"]), union(iv["blocked"]))
    if not staging:
        return None
    idle = subtract([[lo, hi]], probe.busy())
    return 100.0 * total(intersect(idle, clip(union(staging), lo, hi))) \
        / 1e9 / w
