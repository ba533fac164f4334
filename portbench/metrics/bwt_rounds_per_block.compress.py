"""Prefix-doubling rounds a block took part in (``ops/bwt.py``): from
``ops.bwt.ROUND_HOOK``, which reads the card's round record at the end of
each ``bwt_batched`` call (a host sync a call: traced runs only).  A block
takes part in a round while positions of it are still tied; a block the
16-byte key sort resolves counts 0.  Calls that ended in the window."""
import threading
import time


def install(probe):
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.ops import bwt

    local = threading.local()
    acc = probe.counters.setdefault("bwt_rounds", [])

    def hook(stage, k, unres):
        u = unres.numpy().copy()
        st = local.state
        if st["prev"] is None:          # the initial 16-byte ranks
            st["prev"], st["rounds"] = u, (u * 0).astype("int64")
            return
        st["rounds"] += st["prev"] > 0
        st["prev"] = u

    bwt.ROUND_HOOK = hook
    inner = engine.bwt_batched

    def bwt_batched(blocks, n):
        local.state = {"prev": None, "rounds": None}
        out = inner(blocks, n)
        r = local.state["rounds"]
        if r is not None:
            acc.append((time.time_ns(), r.size, int(r.sum())))
        return out

    engine.bwt_batched = bwt_batched


def read(probe):
    rows = [a for a in probe.counters.get("bwt_rounds", [])
            if probe.in_window(a[0])]
    blocks = sum(a[1] for a in rows)
    return sum(a[2] for a in rows) / blocks if blocks else None
