"""The benchmark's one traffic generator: the object pools of every traffic
mix, made from ``--seed`` with NumPy alone (no file of the machine is read),
and the pieces the kinds of data share.

A traffic mix is a data file, ``portbench/traffic/<name>.json``:

``op``
    the operation its clients call, ``portbench/ops/<op>.py``;
``clients``, ``pool``
    closed-loop clients, and distinct objects in the pool (at least one a
    client);
``object_bytes``
    every object's size, or a list of sizes: the pool holds these sizes
    (the list repeated to the pool's length), in an order drawn from the
    run seed, so every seed does the same work;
``data``
    ``kind`` (``portbench/kinds/<kind>.py``), ``language_seed`` and the
    kind's parameters.

The language, a kind's vocabulary or templates, comes from the traffic
file's ``language_seed``, so every run seed draws its objects from the
same language and does the same kind of work; object ``k`` of run seed
``s`` depends on (s, the kind's ``TAG``, k) alone, from its own stream, so
objects may be made on threads in any order.
"""
from __future__ import annotations

import concurrent.futures as cf

import numpy as np

from . import cells


def seed_words(seed: int, *tags: int) -> list:
    """The entropy words of a seed: any whole number, negative or past 64
    bits included, maps to one SeedSequence entropy list."""
    s = int(seed)
    words = [1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return words + [int(t) for t in tags]


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """The random stream of ``seed`` and ``tags``."""
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed,
                                                                   *tags)))


# syllables: onsets, nuclei and codas with English-like weights
_ONSETS = (b"", b"b", b"c", b"d", b"f", b"g", b"h", b"l", b"m", b"n", b"p",
           b"r", b"s", b"t", b"w", b"th", b"sh", b"ch", b"st", b"pr", b"tr",
           b"br", b"gr", b"wh", b"v", b"y", b"k", b"j", b"sp", b"cl")
_ONSET_W = (9, 4, 5, 5, 4, 2, 6, 4, 5, 4, 3, 3, 6, 7, 5, 8, 2, 2, 2, 2, 2,
            1, 1, 2, 1, 1, 1, 0.5, 0.5, 0.5)
_NUCLEI = (b"a", b"e", b"i", b"o", b"u", b"ea", b"ou", b"ai", b"ee", b"oo",
           b"y", b"ie")
_NUCLEUS_W = (10, 12, 8, 8, 3, 2, 2, 1, 1, 1, 1, 1)
_CODAS = (b"", b"n", b"r", b"t", b"s", b"d", b"l", b"nd", b"st", b"ng",
          b"m", b"ll", b"ck", b"rt", b"nt")
_CODA_W = (14, 6, 5, 4, 4, 3, 3, 2, 1, 2, 2, 1, 1, 1, 1)
_SUFFIXES = (b"", b"s", b"ed", b"ing", b"ly", b"er", b"tion", b"ness")
_SUFFIX_W = (70, 10, 7, 6, 3, 2, 1, 1)


def zipf_cdf(n: int, s: float, q: float = 0.0) -> np.ndarray:
    """The CDF of Zipf-Mandelbrot ranks 1..n: p(r) ~ (r + q) ** -s."""
    p = (np.arange(1, n + 1, dtype=np.float64) + q) ** -float(s)
    c = np.cumsum(p)
    return c / c[-1]


def draw(rng, cdf: np.ndarray, n: int) -> np.ndarray:
    """``n`` indices drawn from ``cdf``."""
    return np.minimum(np.searchsorted(cdf, rng.random(n)), cdf.size - 1)


def assemble(pool: np.ndarray, src_off: np.ndarray,
             seg_len: np.ndarray) -> np.ndarray:
    """The bytes of the segments ``pool[src_off[i]:src_off[i] +
    seg_len[i]]``, in order, as one uint8 array (one gather)."""
    seg_len = seg_len.astype(np.int64)
    dst = np.cumsum(seg_len) - seg_len
    shift = np.repeat(src_off.astype(np.int64) - dst, seg_len)
    return pool[np.arange(shift.size, dtype=np.int64) + shift]


class Pool:
    """Byte strings concatenated into one buffer, with their offsets."""

    def __init__(self):
        self.parts: list = []
        self.size = 0

    def add(self, b) -> int:
        a = np.frombuffer(b, np.uint8) if isinstance(b, bytes) \
            else np.ascontiguousarray(b, np.uint8).ravel()
        off = self.size
        self.parts.append(a)
        self.size += a.size
        return off

    def buf(self) -> np.ndarray:
        return np.concatenate(self.parts) if self.parts \
            else np.zeros(0, np.uint8)


# ----------------------------------------------------------- vocabulary
def choice(rng, items, weights, n):
    w = np.asarray(weights, np.float64)
    return [items[i] for i in rng.choice(len(items), size=n, p=w / w.sum())]


def vocabulary(rng, V: int, phrase_share: float) -> list:
    """``V`` vocabulary entries by rank: words of 1-4 syllables (the
    frequent ones shorter) with English-like suffixes, and a share of
    2-3 word phrases made of more frequent entries ("of the", "it was")."""
    nsyl = 1 + np.minimum(3, (np.log1p(np.arange(V)) / 6.0
                              + rng.exponential(0.15, V)).astype(int))
    total = int(nsyl.sum())
    syl = [o + v + c for o, v, c in zip(
        choice(rng, _ONSETS, _ONSET_W, total),
        choice(rng, _NUCLEI, _NUCLEUS_W, total),
        choice(rng, _CODAS, _CODA_W, total))]
    suf = choice(rng, _SUFFIXES, _SUFFIX_W, V)
    phrase = rng.random(V) < phrase_share
    phrase[:20] = False
    out: list = []
    k = 0
    for r in range(V):
        word = b"".join(syl[k:k + nsyl[r]]) + (suf[r] if r >= 40 else b"")
        k += nsyl[r]
        if phrase[r]:
            parts = rng.integers(0, max(1, r // 4), 1 + int(rng.random() < .3))
            word = b" ".join([out[i] for i in parts] + [word.split()[0]])
        out.append(word)
    return out


def pool_size(traffic: dict) -> int:
    return max(int(traffic["pool"]), int(traffic["clients"]))


def object_sizes(traffic: dict, seed: int) -> list:
    """The pool's object sizes for ``seed``: ``object_bytes``, or its list
    repeated to the pool's length in an order drawn from the seed."""
    n = pool_size(traffic)
    spec = traffic["object_bytes"]
    if isinstance(spec, int):
        return [spec] * n
    sizes = np.resize(np.asarray(spec, np.int64), n)
    return [int(x) for x in sizes[rng_for(seed, 0).permutation(n)]]


def make_pool(traffic: dict, seed: int, threads: int = 8,
              root: str = cells.ROOT) -> list:
    """The traffic's pool of distinct objects for ``seed``, as ``bytes``:
    ``pool_size(traffic)`` objects of ``object_sizes`` bytes."""
    d = dict(traffic["data"])
    kind = cells.kind(d.pop("kind"), root)
    mk = kind.Maker(int(d.pop("language_seed")), d)
    sizes = object_sizes(traffic, seed)

    def one(k: int) -> bytes:
        return mk.object(rng_for(seed, kind.TAG, k + 1),
                         sizes[k]).tobytes()

    n = len(sizes)
    with cf.ThreadPoolExecutor(max_workers=max(1, min(threads, n))) as ex:
        return list(ex.map(one, range(n)))
