"""Full-width doubling rounds the card ran a ``bwt_batched`` call
(``ops/bwt.py``, stage 0: the keys, ``sort_pairs`` and rerank over the
plan's B x 2^20 pair buffers): the card's own round counts
(``ops.bwt.stage_rounds``, read once after the warm-up and once after the
window, one sync each and none inside a call) over the program's ``bwt``
spans of the calls whose ``compress`` span began in the window.  None where
the program has no ``stage_rounds`` or records no ``bwt`` span."""


def _stage_rounds():
    from bzip2_tpu_torch.ops import bwt
    fn = getattr(bwt, "stage_rounds", None)
    return None if fn is None else fn()


def install(probe):
    from bzip2_tpu_torch import tracing
    if hasattr(tracing, "enable_spans"):
        tracing.enable_spans(True)


def start(probe):
    install(probe)          # empties the store after the warm-up
    probe.counters["stage_rounds_start"] = _stage_rounds()


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
    before = probe.counters.get("stage_rounds_start")
    after = _stage_rounds()
    bwt = [s for s in _calls_in_window(probe) if s["name"] == "bwt"]
    if before is None or after is None or not bwt:
        return None
    return (after[0] - before[0]) / len(bwt)
