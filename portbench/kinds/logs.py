"""``logs``: server log lines in the shape of Loghub's HDFS and Apache logs
(github.com/logpai/loghub).

``YYYY-MM-DD HH:MM:SS,mmm LEVEL component: message``, timestamps rising by
exponential gaps of mean ``mean_gap_ms``, from ``templates`` seeded
templates (popularity Zipf ``zipf_s``) over ``components`` components,
each message 1-3 seeded fields (decimal ints, 16-digit hex ids, host:port
addresses, block ids; ids drawn Zipf from ``id_pool`` and addresses from
``hosts``, so they recur).
"""
from __future__ import annotations

import numpy as np

from portbench.gen import Pool, assemble, draw, rng_for, vocabulary, zipf_cdf

#: keys the random streams of this kind's templates and objects
TAG = 2

_LEVELS = (b" INFO ", b" WARN ", b" ERROR ", b" DEBUG ")
_LEVEL_P = np.array([0.80, 0.12, 0.05, 0.03])
#: field kinds: decimal int, 16-digit hex id, host:port, block id
_FIELDS = 4


def _dec(vals: np.ndarray, width: int) -> tuple:
    """Decimal digits of non-negative ints: (rows (n, width) uint8 right
    aligned, lengths)."""
    v = vals.astype(np.int64).copy()
    rows = np.empty((v.size, width), np.uint8)
    for j in range(width - 1, -1, -1):
        rows[:, j] = 48 + v % 10
        v //= 10
    ln = np.ones(vals.size, np.int64)
    x = vals.astype(np.int64) // 10
    while np.any(x):
        ln += x > 0
        x //= 10
    return rows, ln


def _hex(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint64)
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    rows = np.empty((v.size, 16), np.uint8)
    for j in range(16):
        rows[:, 15 - j] = digits[((v >> np.uint64(4 * j)) & np.uint64(15))
                                 .astype(np.int64)]
    return rows


class Maker:
    """Objects of log lines from the templates of ``language_seed``."""

    def __init__(self, language_seed: int, p: dict):
        rng = rng_for(language_seed, TAG, 0)
        T = int(p["templates"])
        K = int(p["components"])
        vocab = vocabulary(rng, 600, 0.0)
        caps = [w[:1].upper() + w[1:] for w in vocab]
        comps = []
        for _ in range(K):
            pk = [vocab[i] for i in rng.integers(0, len(vocab), 2)]
            cl = [caps[i] for i in rng.integers(0, len(caps), 2)]
            comps.append(b"org." + b".".join(pk) + b"." + b"".join(cl)
                         + b": ")
        self.lit = Pool()
        self.level_off = [self.lit.add(b) for b in _LEVELS]
        self.comp_off = [self.lit.add(c) for c in comps]
        self.comp_len = [len(c) for c in comps]
        # a host literal carries the colon of its host:port field
        hosts = [b"10.%d.%d.%d:" % tuple(rng.integers(0, 256, 3))
                 for _ in range(int(p["hosts"]))]
        self.host_off = np.array([self.lit.add(h) for h in hosts])
        self.host_len = np.array([len(h) for h in hosts])
        self.host_cdf = zipf_cdf(len(hosts), 1.0)
        self.blk = self.lit.add(b"blk_")
        # a template: level, component, 4 literal pieces, 1-3 field kinds
        self.t_level = rng.choice(4, size=T, p=_LEVEL_P)
        self.t_comp = rng.integers(0, K, T)
        self.t_nf = rng.integers(1, 4, T)
        self.t_kind = rng.integers(0, _FIELDS, (T, 3))
        self.t_piece_off = np.zeros((T, 4), np.int64)
        self.t_piece_len = np.zeros((T, 4), np.int64)
        for t in range(T):
            for j in range(4):
                if j > self.t_nf[t]:
                    continue
                nw = int(rng.integers(1, 6)) if j == 0 else \
                    int(rng.integers(0, 4))
                ws = [vocab[i] for i in rng.integers(0, len(vocab), nw)]
                if j == 0:
                    s = b" ".join([ws[0][:1].upper() + ws[0][1:]] + ws[1:]) \
                        + b" "
                else:
                    s = b" " + b" ".join(ws) + (b" " if ws else b"")
                if j == self.t_nf[t]:
                    s = s.rstrip(b" ") + b"\n"
                self.t_piece_off[t, j] = self.lit.add(s)
                self.t_piece_len[t, j] = len(s)
        self.t_cdf = zipf_cdf(T, p["zipf_s"])
        self.id_cdf = zipf_cdf(int(p["id_pool"]), 1.0)
        self.ids = rng.integers(0, 2 ** 63, int(p["id_pool"]),
                                dtype=np.int64)
        self.t0_ms = int(np.datetime64("2026-01-01T00:00:00", "ms")
                         .astype(np.int64)) + int(rng.integers(0, 300)) \
            * 86_400_000
        self.p = p
        self.lit_buf = self.lit.buf()

    def object(self, rng, nbytes: int) -> np.ndarray:
        out = []
        have = 0
        t_ms = self.t0_ms + int(rng.integers(0, 86_400_000))
        while have < nbytes:
            n = int((nbytes - have) / 90 * 1.1) + 64
            chunk, t_ms = self._chunk(rng, n, t_ms)
            out.append(chunk)
            have += chunk.size
        return np.concatenate(out)[:nbytes]

    def _chunk(self, rng, n: int, t_ms: int):
        p = self.p
        pool = Pool()
        lit_base = pool.add(self.lit_buf)
        gaps = rng.exponential(float(p["mean_gap_ms"]), n).astype(np.int64)
        ms = t_ms + np.cumsum(gaps)
        ts = np.datetime_as_string(ms.astype("datetime64[ms]")) \
            .astype("S23").view(np.uint8).reshape(n, 23).copy()
        ts[:, 10] = 32          # 'T' -> ' '
        ts[:, 19] = 44          # '.' -> ','
        ts_off = pool.add(ts)
        t = draw(rng, self.t_cdf, n)
        S = 3 + 4 + 3 * 2       # ts, level, component, 4 pieces, 3 fields
        src = np.zeros((n, S), np.int64)
        ln = np.zeros((n, S), np.int64)
        src[:, 0] = ts_off + 23 * np.arange(n)
        ln[:, 0] = 23
        lvl = np.asarray(self.level_off)[self.t_level[t]]
        src[:, 1] = lit_base + lvl
        ln[:, 1] = np.array([len(b) for b in _LEVELS])[self.t_level[t]]
        src[:, 2] = lit_base + np.asarray(self.comp_off)[self.t_comp[t]]
        ln[:, 2] = np.asarray(self.comp_len)[self.t_comp[t]]
        for j in range(4):
            c = 3 + 3 * j
            src[:, c] = lit_base + self.t_piece_off[t, j]
            ln[:, c] = self.t_piece_len[t, j]
        # the fields' values: every kind for every line, used where the
        # template has that field
        dec_rows, dec_len = _dec(rng.integers(0, 100_000, (n, 3)).ravel(), 6)
        dec_off = pool.add(dec_rows)
        hex_rows = _hex(self.ids[draw(rng, self.id_cdf, 3 * n)])
        hex_off = pool.add(hex_rows)
        ports, port_len = _dec(rng.integers(1024, 65536, 3 * n), 5)
        port_off = pool.add(ports)
        host = draw(rng, self.host_cdf, 3 * n)
        blk_rows, blk_len = _dec((self.ids[draw(rng, self.id_cdf, 3 * n)]
                                  % 10 ** 18), 18)
        blk_off = pool.add(blk_rows)
        idx = np.arange(3 * n)
        for f in range(3):
            c = 4 + 3 * f
            on = self.t_nf[t] > f
            kind = self.t_kind[t, f]
            i = idx[f::3]
            # part a: host / "blk_" / nothing; part b: the value
            a_src = np.where(kind == 2, lit_base + self.host_off[host[i]],
                             lit_base + self.blk)
            a_len = np.where(kind == 2, self.host_len[host[i]] + 0,
                             np.where(kind == 3, 4, 0))
            b_src = np.select(
                [kind == 0, kind == 1, kind == 2],
                [dec_off + 6 * i + 6 - dec_len[i], hex_off + 16 * i,
                 port_off + 5 * i + 5 - port_len[i]],
                blk_off + 18 * i + 18 - blk_len[i])
            b_len = np.select([kind == 0, kind == 1, kind == 2],
                              [dec_len[i], np.full(n, 16), port_len[i]],
                              blk_len[i])
            src[:, c] = a_src
            ln[:, c] = np.where(on, a_len, 0)
            src[:, c + 1] = b_src
            ln[:, c + 1] = np.where(on, b_len, 0)
        buf = assemble(pool.buf(), src.ravel(), ln.ravel())
        return buf, int(ms[-1])
