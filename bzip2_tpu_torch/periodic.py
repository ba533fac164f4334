# Copied from bzip2_tpu/periodic.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Exactly-periodic blocks: stock-exact origPtr tie correction.

For an exactly-periodic block (minimal period p dividing n, p < n) every
rotation in a tie class is the same string, so the BWT last column, the
compressed size, and the decode are invariant to which in-class slot the
24-bit origPtr field names.  The two reference-lineage implementations
*disagree with each other* on these inputs (measured 2026-08-19: divsufsort
fork origPtr=1 vs stock 299 on b"ab"*300 — see tools/origptr_sweep.py
--fork), so there is no single "reference bit pattern"; this repo's
bit-exactness oracle is stock bzip2 (stdlib bz2 == libbz2 1.0.8), which all
tests and the bench pin.

Our sorters use the last-in-class slot (class base + m - 1), which matches
stock on every regular periodic family; the adversarial residue follows
stock's sorter tie dynamics and has no closed form (exhaustive sweep in
tools/origptr_sweep.py: slots like [1,2,1,1,2,0,3,1] across m).  Which
stock sorter emits the slot depends on block size:

- n < 10000: stock calls its fallback sorter DIRECTLY (stock
  BZ2_blockSort: ``if (nblock < 10000) fallbackSort``), whose only
  nondeterminism source is a fixed LCG (r = (7621 r + 1) mod 32768) — the
  slot is exactly reproducible by replaying the dynamics.
  ``native.fallback_origptr`` (C++, bz2tpu_host.cpp) does that.
- n >= 10000: stock runs mainSort first and reaches the fallback only if
  the nblock*((workFactor-1)/3) budget blows.  That blow is NOT guaranteed:
  a large-period/few-repeat block (e.g. a random 1000-byte root x11)
  completes mainSort inside budget, and the emitted slot is mainSort's tie
  choice, not the fallback's (ADVICE r4, verified with bzip2 -vvvv).
  Modeling mainSort's budget + tie dynamics would mean transcribing it, so
  for these blocks the corrector consults stock itself: re-compress the
  raw bytes with the stdlib (same libbz2 1.0.8 code) and read the 24-bit
  field back.  This is the one place the framework calls stdlib bz2 at
  encode time; it is exact by construction and content-digest cached.

Both paths run only on blocks that are exactly periodic post-RLE1 — a
measure-zero family on real data (the detection fast-path costs ~100 us
per block).
"""
from __future__ import annotations

import hashlib as _hashlib
import math as _math

import numpy as np

from . import native, tracing

# blake2b(block bytes) -> origPtr.  Periodic streams repeat identical
# blocks, so a tiny LRU absorbs the pathological case (ADVICE r3: digest
# keys instead of retaining block bytes; evict oldest-first).
_CACHE: dict[bytes, int] = {}
_CACHE_MAX = 256

# Stock BZ2_blockSort's direct-fallback threshold: below this the replayed
# fallback dynamics are provably the sorter stock ran.
_FALLBACK_DIRECT_MAX = 10000

# Observability: how many periodic patches were applied / skipped (a skip
# ships our own in-class slot — still a valid decodable stream, just not
# bit-identical to stock on that block).  tests + tracing read these.
COUNTERS = {"patched": 0, "skipped_probe": 0, "skipped_range": 0}


def exact_period(d: np.ndarray) -> int:
    """Minimal period p of d that divides n (p == n when not periodic).

    Only the maximal proper divisors n/q (q prime) are tested: a proper
    period p | n divides some n/q, and shift-invariance under p implies
    invariance under its multiple n/q; the invariant shifts form a
    subgroup of Z_n, so the gcd g of the invariant maximal divisors is a
    period, and the minimal one is found by recursing on the length-g
    root (the minimal period divides g).  Bounds encode-time work on
    adversarial inputs to ~log^2 n full compares (ADVICE r3) with cheap
    1-byte/64-byte probes rejecting real data first."""
    n = int(d.size)
    if n < 2:
        return n
    m, q, primes = n, 2, []
    while q * q <= m:
        if m % q == 0:
            primes.append(q)
            while m % q == 0:
                m //= q
        q += 1
    if m > 1:
        primes.append(m)
    g = n
    for q in primes:
        p = n // q
        if d[p] != d[0]:
            continue
        if n - p >= 64 and not np.array_equal(d[p:p + 64], d[:64]):
            continue
        if np.array_equal(d[p:], d[:n - p]):
            g = _math.gcd(g, p)
    return g if g == n else exact_period(d[:g])


def stock_dynamics_origptr(block_data: np.ndarray) -> int:
    """origPtr stock bzip2 emits for a block with exactly this post-RLE1
    content when its fallback sorter runs (n < 10000 runs it directly),
    computed by replaying the fallback dynamics in the native runtime.
    Content-digest cached."""
    d = np.ascontiguousarray(block_data, dtype=np.uint8)
    key = _hashlib.blake2b(d.tobytes(), digest_size=16).digest()
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    op = native.fallback_origptr(d)
    while len(_CACHE) >= _CACHE_MAX:        # oldest-first eviction
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = op
    return op


def stock_origptr_probe(block_data: np.ndarray, level: int) -> int | None:
    """Stock bzip2's origPtr for a block with exactly this post-RLE1
    content, read back from an actual stdlib-bz2 compress of the raw
    bytes, or None when the probe cannot be applied safely.  Used for
    n >= 10000 periodic blocks where mainSort may complete inside budget
    and emit its own tie slot (no closed form; ADVICE r4)."""
    import bz2 as _stdlib_bz2

    from . import rle1 as _rle1

    d = np.ascontiguousarray(block_data, dtype=np.uint8)
    key = _hashlib.blake2b(d.tobytes() + bytes([level]),
                           digest_size=16).digest()
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    raw = _rle1.decode(d)
    # Safety: the raw bytes must RLE1-split back to exactly this one block
    # (guards the one-shot/chunked final-segment corner in rle1.py).
    re = _rle1.encode_blocks(raw, level)
    if len(re) != 1 or not np.array_equal(re[0].data, d):
        return None
    comp = _stdlib_bz2.compress(raw.tobytes(), level)
    # field at stream bits 113..136: 32 hdr + 48 magic + 32 CRC + 1 rand
    op = (int.from_bytes(comp[14:18], "big") >> 7) & 0xFFFFFF
    while len(_CACHE) >= _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = op
    return op


def patch_payload(payload: np.ndarray, nbits: int, block_data: np.ndarray,
                  level: int):
    """Return (payload, nbits) with the origPtr field rewritten to stock's
    slot iff the block is exactly periodic; otherwise the input unchanged.

    payload: uint8 MSB-first block bits starting at the 48-bit block magic;
    the origPtr field sits at payload bits 81..104 (48 magic + 32 CRC +
    1 rand bit).
    """
    d = np.asarray(block_data, np.uint8)
    if exact_period(d) >= d.size:
        return payload, nbits
    if d.size < _FALLBACK_DIRECT_MAX:
        op = stock_dynamics_origptr(d)
    else:
        op = stock_origptr_probe(d, level)
        if op is None:
            COUNTERS["skipped_probe"] += 1
            import warnings
            warnings.warn(
                "periodic origPtr probe inapplicable for a "
                f"{d.size}-byte block; shipping our own tie slot "
                "(stream decodes correctly, may differ from stock in "
                "the 24-bit origPtr field)", RuntimeWarning,
                stacklevel=2)
            return payload, nbits
    if not 0 <= op < d.size:
        COUNTERS["skipped_range"] += 1
        import warnings
        warnings.warn(
            f"periodic origPtr corrector produced out-of-range slot {op} "
            f"for a {d.size}-byte block; shipping our own tie slot",
            RuntimeWarning, stacklevel=2)
        return payload, nbits
    COUNTERS["patched"] += 1
    out = np.array(payload, np.uint8, copy=True)
    # payload bits 81..104 live in bytes 10..13 (bits 80..111); rewrite
    # local bit positions 1..24 with op MSB-first
    bits = np.unpackbits(out[10:14])
    bits[1:25] = (op >> (23 - np.arange(24))) & 1
    out[10:14] = np.packbits(bits)
    return out, nbits


def patch_payloads(payloads: list, blocks: list, level: int) -> list:
    """Patch a payload list in block order; cheap no-op on non-periodic
    blocks (the overwhelmingly common case)."""
    out = list(payloads)
    with tracing.span("patch", None):
        for i, blk in enumerate(blocks):
            if i < len(out) and out[i] is not None:
                p, nb = out[i]
                out[i] = patch_payload(np.asarray(p, np.uint8), nb,
                                       blk.data, level)
    return out
