"""Inputs for the RLE1 split's wide path (bzip2_tpu_torch/native/
bz2tpu_host.cpp, ``bz2tpu_rle1_split``), shared by the parity tests
(tests/test_torch_host.py) and the sanitizer and no-AVX2 builds
(tests/test_torch_native.py).  Imports neither JAX nor the JAX package;
every case is made from a numpy seed.

The wide path copies a window of 32 bytes (16 without AVX2) at a segment
start when no run of 4 starts in it, so the cases put runs at every offset
of a run-free stretch and around the windows' edges, cut inputs at every
length near the path's 35-byte look-ahead, and close blocks at every
budget near its 32-byte room guard.  A case is (data bytes, level, nmax
override or None).
"""
import hashlib

import numpy as np

#: run lengths around RLE1's thresholds: under 4, 4, 5, and around the
#: 255-byte segment chop
RUN_LENGTHS = (3, 4, 5, 255, 256, 259)
#: the windows' edges of a run-free stretch read from its start
EDGES = (32, 64, 96, 128)
#: block budgets around the room guard: the whole of 1-70 and 100-140
NMAX_RANGES = {"1-70": range(1, 71), "100-140": range(100, 141)}
SEEDS = tuple(range(6))


def run_free(n: int, seed: int) -> bytes:
    """``n`` bytes with no byte equal to the one before it."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(1, 256, n)) % 256).astype(np.uint8) \
        .tobytes()


def with_run(base: bytes, at: int, length: int) -> bytes:
    """``base`` with a run of ``length`` equal bytes inserted at ``at``,
    its byte unequal to its neighbours so that the run stays whole."""
    near = set(base[max(at - 1, 0):at + 1])
    v = next(b for b in range(256) if b not in near)
    return base[:at] + bytes([v]) * length + base[at:]


def mix(seed: int, n_parts: int = 200) -> bytes:
    """Run-free stretches of 1-80 bytes and runs of 1-300, seeded."""
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(n_parts):
        if rng.random() < 0.5:
            parts.append(run_free(int(rng.integers(1, 81)), seed * 1000 + k))
        else:
            parts.append(bytes([int(rng.integers(0, 256))])
                         * int(rng.integers(1, 301)))
    return b"".join(parts)


def run_at_offsets(length: int) -> list:
    """A run of ``length`` at each offset 0-40 of a run-free stretch."""
    base = run_free(120, length)
    return [(with_run(base, at, length), 9, None) for at in range(41)]


def run_at_edge(edge: int) -> list:
    """A run of 4 at each position from 8 before a window's edge to 8
    after it, behind lead-ins that shift the edge by 0, 5 and 17 bytes."""
    out = []
    for lead in (0, 5, 17):
        base = run_free(edge + 80 + lead, edge + lead)
        out += [(with_run(base, lead + at, 4), 9, None)
                for at in range(edge - 8, edge + 9)]
    return out


def every_length(kind: str) -> list:
    """Each length 0-70 of a run-free input or of a seeded mix."""
    src = run_free(70, 1) if kind == "run-free" else mix(7, 20)[:70]
    return [(src[:n], 1, None) for n in range(71)]


def block_budgets(which: str) -> list:
    """One input of run-free stretches, a few runs and ten runs of 4 back
    to back (blocks close inside a window's bytes), split at each block
    budget of ``NMAX_RANGES[which]``."""
    quads = b"".join(bytes([v]) * 4 for v in range(20, 30))
    data = (run_free(300, 2) + b"\x07" * 9 + run_free(200, 3) + b"\x09" * 4
            + run_free(150, 4) + quads + run_free(100, 6) + b"\x0b" * 260
            + run_free(100, 5))
    return [(data, 1, nmax) for nmax in NMAX_RANGES[which]]


def seeded_mix(seed: int) -> list:
    """A seeded mix at its level's budget and at a small one."""
    data = mix(seed)
    return [(data, 1 + seed % 9, None), (data, 1, 500 + 37 * seed)]


def groups() -> dict:
    """Every case group, by name."""
    out = {f"run{n}-at-offsets": run_at_offsets(n) for n in RUN_LENGTHS}
    out.update({f"run4-at-edge{e}": run_at_edge(e) for e in EDGES})
    out.update({f"length-{k}": every_length(k) for k in ("run-free", "mix")})
    out.update({f"nmax-{w}": block_budgets(w) for w in NMAX_RANGES})
    out.update({f"mix-seed{s}": seeded_mix(s) for s in SEEDS})
    return out


def summary(blocks) -> list:
    """A comparable record of ``encode_blocks``'s blocks: each block's
    bytes (their SHA-256), ``in_use``, CRC and raw span."""
    return [[hashlib.sha256(bytes(b.data)).hexdigest(),
             np.flatnonzero(b.in_use).tolist(), int(b.crc), list(b.raw_span)]
            for b in blocks]
