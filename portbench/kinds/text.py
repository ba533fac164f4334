"""``text``: English-like prose, the shape of a corpus such as Silesia's
``dickens``.

A seeded vocabulary of ``vocabulary`` entries (words of 1-4 syllables
built from English-like onsets, nuclei and codas, the frequent words
shorter, with suffixes; a ``phrase_share`` of them 2-3 word phrases),
entries drawn Zipf-Mandelbrot (``p(r) ~ (r + zipf_q) ** -zipf_s``),
sentences of about ``sentence_words`` words with a capital first letter and
a closing '.', '?' or '!', commas (``comma_p``), lines wrapped near
``line_chars`` and a blank line between paragraphs (``paragraph_p`` at a
sentence's end).
"""
from __future__ import annotations

import numpy as np

from portbench.gen import Pool, assemble, draw, rng_for, vocabulary, zipf_cdf

#: keys the random streams of this kind's language and objects
TAG = 1


class Maker:
    """Objects of English-like text in the language of ``language_seed``."""

    def __init__(self, language_seed: int, p: dict):
        rng = rng_for(language_seed, TAG, 0)
        V = int(p["vocabulary"])
        words = vocabulary(rng, V, float(p["phrase_share"]))
        self.wlen = np.array([len(w) for w in words], np.int64)
        self.vocab = np.frombuffer(b"".join(words), np.uint8)
        self.woff = np.cumsum(self.wlen) - self.wlen
        self.cdf = zipf_cdf(V, p["zipf_s"], p.get("zipf_q", 0.0))
        self.p = p
        self.mean_tok = float(np.sum(np.diff(np.concatenate([[0.0],
                                                             self.cdf]))
                                     * self.wlen))

    def object(self, rng, nbytes: int) -> np.ndarray:
        p = self.p
        out = []
        have = 0
        while have < nbytes:
            n = int((nbytes - have) / (self.mean_tok + 1.2) * 1.05) + 64
            chunk = self._chunk(rng, n, int(p["line_chars"]))
            out.append(chunk)
            have += chunk.size
        return np.concatenate(out)[:nbytes]

    def _chunk(self, rng, n: int, width: int) -> np.ndarray:
        p = self.p
        tok = draw(rng, self.cdf, n)
        wl = self.wlen[tok]
        end = rng.random(n) < 1.0 / float(p["sentence_words"])
        end[-1] = True
        comma = ~end & (rng.random(n) < float(p["comma_p"]))
        para = end & (rng.random(n) < float(p["paragraph_p"]))
        start = np.concatenate([[True], end[:-1]])
        u = rng.random(n)
        # '.' 88%, '?' 8%, '!' 4% at a sentence's end
        pch = np.where(end, np.where(u < 0.88, 46, np.where(u < 0.96, 63,
                                                            33)),
                       np.where(comma, 44, 0)).astype(np.uint8)
        has_p = pch > 0
        # lines wrap near ``width``: a newline after the word that crosses
        # a multiple of it
        seg = wl + has_p + 1 + para
        cum = np.cumsum(seg)
        line = cum // width
        nl = para | np.concatenate([line[1:] != line[:-1], [True]])
        sep = np.where(nl, 10, 32).astype(np.uint8)
        lit = Pool()
        voff = lit.add(self.vocab)
        poff = lit.add(pch)
        soff = lit.add(sep)
        noff = lit.add(b"\n")
        # segments a token: word, punctuation, separator, paragraph newline
        src = np.stack([voff + self.woff[tok], poff + np.arange(n),
                        soff + np.arange(n), np.full(n, noff)], axis=1)
        ln = np.stack([wl, has_p.astype(np.int64), np.ones(n, np.int64),
                       para.astype(np.int64)], axis=1)
        buf = assemble(lit.buf(), src.ravel(), ln.ravel())
        # capital letter at each sentence's start
        first = (np.cumsum(ln.sum(axis=1)) - ln.sum(axis=1))[start]
        buf[first] -= 32
        return buf
