"""Host milliseconds a MiB compressed that the engine's device workers
spend blocked on the card, read from the program's own spans
(``bzip2_tpu_torch.tracing.span``): the ``wait`` spans (the device reads
of a batch: ``n_in_use``, four ``freq``, ``nbits`` and ``words``), summed
over every worker, of every call whose ``compress`` span began in the
window, over the MiB of the calls begun in the window.  None where the
program records no spans."""


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
    wait = [s for s in _calls_in_window(probe) if s["name"] == "wait"]
    if not wait or not probe.mib_started:
        return None
    return sum(s["t1_ns"] - s["t0_ns"] for s in wait) / 1e6 / probe.mib_started
