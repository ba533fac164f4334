"""The plain reference that decides ``correct``, and the controls.

The configurations state stock bzip2's guarantees: a stream byte for byte
the one bzip2 1.0.x writes at the level, and a decode that gives back every
byte.  The reference is therefore the upstream implementation itself,
Python's ``bz2`` module (libbz2), independent of the port: it reads
nothing the port made except the outputs it judges, and imports nothing
of ``bzip2_tpu_torch`` or ``bzip2_tpu``.

* compress: each call's stream must equal ``bz2.compress(object, level)``
  (header, every block, block CRCs, combined CRC; exact, limit 0);
* decompress: each call's bytes must equal the object the generator made
  (exact, limit 0); the streams it decodes are made by ``bz2`` in set-up.

The controls break one stated guarantee with the reference in the
program's place: ``bz2`` at the next block size (level - 1; level 2 for
level 1), which is a valid stream that decodes to the same bytes but is
not the level's stream; and for decompress, ``bz2``'s decode with the
stream's last block of bytes lost.
"""
from __future__ import annotations

import bz2
import concurrent.futures as cf


def compress(data: bytes, level: int) -> bytes:
    return bz2.compress(data, level)


def compress_all(objects: list, level: int, threads: int = 8) -> list:
    """``bz2.compress`` of every object, on a thread pool (libbz2 releases
    the GIL)."""
    with cf.ThreadPoolExecutor(max_workers=max(1, min(threads,
                                                      len(objects)))) as ex:
        return list(ex.map(lambda d: compress(d, level), objects))


def control_level(level: int) -> int:
    return level - 1 if level > 1 else 2


def control_compress(data: bytes, level: int) -> bytes:
    """The compress control: a valid stream of another block size."""
    return bz2.compress(data, control_level(level))


def control_decompress(stream: bytes, level: int) -> bytes:
    """The decompress control: the decode with its last block's bytes
    (``level`` x 100,000) lost."""
    out = bz2.decompress(stream)
    return out[:max(0, len(out) - 100_000 * level)]


def first_difference(a: bytes, b: bytes) -> int:
    """The first offset where ``a`` and ``b`` differ (-1 if equal)."""
    if a == b:
        return -1
    n = min(len(a), len(b))
    lo, hi = 0, n
    while hi - lo > 4096:
        mid = (lo + hi) // 2
        if a[lo:mid] == b[lo:mid]:
            lo = mid
        else:
            hi = mid
    for i in range(lo, hi):
        if a[i] != b[i]:
            return i
    return n


def host_probe(nbytes: int = 2 << 20) -> float:
    """Milliseconds a MiB that ``bz2.compress(-9)`` takes on one thread for
    a fixed buffer (the same bytes in every run): a reading of the host
    CPU's speed, independent of the seed and of the program."""
    import time

    import numpy as np

    data = np.random.default_rng(20261018).integers(
        97, 123, nbytes, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    compress(data, 9)
    return (time.perf_counter() - t0) * 1e3 / (nbytes / 2 ** 20)
