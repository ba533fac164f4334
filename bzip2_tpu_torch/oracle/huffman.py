# Copied from bzip2_tpu/oracle/huffman.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Canonical Huffman construction with reference-exact tie-breaking.

bzip2's code lengths come from a binary-heap Huffman builder whose keys pack
``(weight << 8) | depth`` and whose parent weight is
``(w1 + w2) | (1 + max(d1, d2))`` (reference huffman.c:25-148).  Tie order
inside the heap affects the resulting length multiset, so bit-exact output
requires reproducing the exact heap discipline: strict-less-than sift-up,
sift-down choosing the right child only when strictly smaller, insertion
order 1..alphaSize, and the halve-and-retry loop when a code exceeds
``maxLen``.  This module implements that contract in Python (the batched
C++ runtime and tests validate against it).
"""
from __future__ import annotations

import numpy as np


def make_code_lengths(freq, alpha_size: int, max_len: int = 17) -> np.ndarray:
    """Code lengths (int array of ``alpha_size``) for the given frequencies."""
    weight = [0] * (alpha_size * 2 + 2)
    parent = [0] * (alpha_size * 2 + 2)
    heap = [0] * (alpha_size + 2)

    for i in range(alpha_size):
        f = int(freq[i])
        weight[i + 1] = (f if f else 1) << 8

    lens = np.zeros(alpha_size, np.int32)
    while True:
        n_nodes = alpha_size
        n_heap = 0
        heap[0] = 0
        weight[0] = 0
        parent[0] = -2

        for i in range(1, alpha_size + 1):
            parent[i] = -1
            n_heap += 1
            # sift up (strict <)
            zz = n_heap
            tmp = i
            while weight[tmp] < weight[heap[zz >> 1]]:
                heap[zz] = heap[zz >> 1]
                zz >>= 1
            heap[zz] = tmp

        def pop_min():
            nonlocal n_heap
            top = heap[1]
            tmp = heap[n_heap]
            n_heap -= 1
            # sift down: pick right child only when strictly smaller
            zz = 1
            while True:
                yy = zz << 1
                if yy > n_heap:
                    break
                if yy < n_heap and weight[heap[yy + 1]] < weight[heap[yy]]:
                    yy += 1
                if weight[tmp] < weight[heap[yy]]:
                    break
                heap[zz] = heap[yy]
                zz = yy
            heap[zz] = tmp
            return top

        while n_heap > 1:
            n1 = pop_min()
            n2 = pop_min()
            n_nodes += 1
            parent[n1] = parent[n2] = n_nodes
            w1, w2 = weight[n1], weight[n2]
            d1, d2 = w1 & 0xFF, w2 & 0xFF
            weight[n_nodes] = ((w1 & ~0xFF) + (w2 & ~0xFF)) | (1 + max(d1, d2))
            parent[n_nodes] = -1
            n_heap += 1
            zz = n_heap
            tmp = n_nodes
            while weight[tmp] < weight[heap[zz >> 1]]:
                heap[zz] = heap[zz >> 1]
                zz >>= 1
            heap[zz] = tmp

        too_long = False
        for i in range(1, alpha_size + 1):
            j = 0
            k = i
            while parent[k] >= 0:
                k = parent[k]
                j += 1
            lens[i - 1] = j
            if j > max_len:
                too_long = True
        if not too_long:
            return lens
        # Halve-and-retry (huffman.c:142-146).
        for i in range(1, alpha_size + 1):
            j = weight[i] >> 8
            weight[i] = (1 + (j // 2)) << 8


def assign_codes(lengths: np.ndarray, alpha_size: int) -> np.ndarray:
    """Canonical codes: ascending code length, then symbol order
    (huffman.c:152-166)."""
    lens = np.asarray(lengths[:alpha_size])
    codes = np.zeros(alpha_size, np.int64)
    vec = 0
    for n in range(int(lens.min()), int(lens.max()) + 1):
        sel = np.flatnonzero(lens == n)
        codes[sel] = vec + np.arange(sel.size)
        vec = (vec + sel.size) << 1
    return codes


class BadTableError(ValueError):
    pass


def build_decode_table(lengths: np.ndarray, alpha_size: int):
    """Canonical decode metadata: (min_len, max_len, limit, base, perm).

    ``limit[l]`` is the largest code value of length l, ``base[l]`` offsets
    into ``perm`` (symbols ordered by (length, symbol)).  Raises
    BadTableError if the lengths are not a valid (complete or over-full)
    prefix code, matching the reference's Kraft validation
    (huffman.c:209-210,232: reject over-subscribed at any length, and
    under-subscribed tables are rejected when the total doesn't close).
    """
    lens = np.asarray(lengths[:alpha_size], np.int64)
    if np.any(lens < 1) or np.any(lens > 23):
        raise BadTableError("length out of range")
    min_len = int(lens.min())
    max_len = int(lens.max())
    counts = np.bincount(lens, minlength=max_len + 2)
    perm = np.argsort(lens, kind="stable").astype(np.int32)
    limit = np.zeros(max_len + 2, np.int64)
    base = np.zeros(max_len + 2, np.int64)
    code = 0
    total = 0
    for l in range(min_len, max_len + 1):
        base[l] = code - total  # perm index of first code of this length is total
        code += int(counts[l])
        total += int(counts[l])
        limit[l] = code - 1
        code <<= 1
    # Kraft sum check: codes must exactly fill the space (equivalent to the
    # reference's base[8]/closure validation in huffman.c:209-210,232).
    kraft = int((counts[min_len:max_len + 1] *
                 (1 << (max_len - np.arange(min_len, max_len + 1)))).sum())
    if kraft != (1 << max_len):
        raise BadTableError("incomplete or over-subscribed code")
    return min_len, max_len, limit, base, perm
