"""Reference-exact Huffman code lengths and canonical code assignment
(port of ``bzip2_tpu/ops/huffman.py``; huffman.c:25-166).

``make_code_lengths_lanes`` builds the code lengths of many (block, table)
lanes at once: on a CUDA tensor it launches the hand-written kernel of
``csrc/huffman_lengths.cu`` (counter ``huffman_lengths``), on a CPU tensor
it runs ``make_code_lengths_lanes_plain``, the JAX ``_attempt`` /
``_one_lane`` loops written as torch ops vectorised over lanes.  The fused
encoder calls it four times a batch; the hybrid encoder builds the same
lengths on the host (``native.make_code_lengths_batch``).

The heap discipline decides the length multiset: packed keys
``(weight << 8) | depth``, strict ``<`` sift-up, sift-down taking the right
child only when it is strictly smaller, insertion order 1..alpha, parent
key ``(w1 + w2) | (1 + max(d1, d2))``, and halve-and-retry while a leaf's
depth exceeds 17, at most 24 halvings (the JAX bound; in-domain weights
reach a balanced tree sooner).  As in JAX, the output row holds the depth
of node ``i + 1`` at index ``i`` for all 258 indices: the leaves below
``alpha``, the internal nodes (numbered from ``alpha + 1``) above it, and
0 for nodes that never got a parent.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build
from ..constants import MAX_ALPHA_SIZE as A

MAX_LEN = 17
MAX_HALVINGS = 24
_CHAIN_DOUBLINGS = 9  # parent chains have length <= 257 < 2^9

KERNEL = _build.Kernel("huffman_lengths", "bz2t_huffman_lengths",
                       [ct.c_void_p] * 3 + [ct.c_int, ct.c_void_p])


def _upheap(heap, weight, rows, zz, node, active, steps):
    """Sift ``node`` up from slot ``zz`` on the lanes where ``active``."""
    wt = weight[rows, node]
    done = ~active
    for _ in range(steps):
        par = heap[rows, zz >> 1]
        move = ~done & (wt < weight[rows, par])
        heap[rows, zz] = torch.where(move, par, heap[rows, zz])
        zz = torch.where(move, zz >> 1, zz)
        done = done | ~move
    heap[rows, zz] = torch.where(active, node, heap[rows, zz])


def _downheap(heap, weight, rows, n_heap, active, steps):
    """Sift the key at slot 1 down a heap of ``n_heap`` on active lanes."""
    top = heap.shape[1] - 1
    tmp = heap[rows, 1]
    wt = weight[rows, tmp]
    zz = torch.ones_like(n_heap)
    done = ~active
    for _ in range(steps):
        yy = zz << 1
        cont = ~done & (yy <= n_heap)
        right = (cont & (yy < n_heap)
                 & (weight[rows, heap[rows, (yy + 1).clamp(max=top)]]
                    < weight[rows, heap[rows, yy.clamp(max=top)]]))
        yy = (yy + right.to(yy.dtype)).clamp(max=top)
        move = cont & ~(wt < weight[rows, heap[rows, yy]])
        heap[rows, zz] = torch.where(move, heap[rows, yy], heap[rows, zz])
        zz = torch.where(move, yy, zz)
        done = done | ~move
    heap[rows, zz] = torch.where(active, tmp, heap[rows, zz])


def _attempt(weight_leaf: torch.Tensor, alpha: torch.Tensor):
    """One Huffman build per lane.  weight_leaf: (L, A+1) packed leaf keys
    (index 0 is the sentinel 0).  Returns (lens (L, A), too_long (L,))."""
    L = weight_leaf.shape[0]
    dev = weight_leaf.device
    i32 = torch.int32
    rows = torch.arange(L, device=dev)
    amax = int(alpha.max())
    steps = max(1, amax.bit_length())        # heap depth of amax entries
    weight = torch.zeros((L, 2 * A + 2), dtype=i32, device=dev)
    weight[:, :A + 1] = weight_leaf
    parent = torch.full((L, 2 * A + 2), -1, dtype=i32, device=dev)
    parent[:, 0] = -2
    heap = torch.zeros((L, A + 2), dtype=torch.int64, device=dev)
    n_heap = torch.zeros(L, dtype=torch.int64, device=dev)

    for i in range(1, amax + 1):                 # insert leaves 1..alpha
        do = i <= alpha
        n_heap = n_heap + do.to(n_heap.dtype)
        _upheap(heap, weight, rows, n_heap, torch.full_like(n_heap, i), do,
                steps)

    n_nodes = alpha.to(torch.int64)
    for _ in range(amax - 1):                    # alpha - 1 merges a lane
        do = n_heap > 1
        d = do.to(n_heap.dtype)
        n1 = heap[rows, 1]
        heap[rows, 1] = torch.where(do, heap[rows, n_heap], heap[rows, 1])
        nh = n_heap - d
        _downheap(heap, weight, rows, nh, do, steps)
        n2 = heap[rows, 1]
        heap[rows, 1] = torch.where(do, heap[rows, nh], heap[rows, 1])
        nh = nh - d
        _downheap(heap, weight, rows, nh, do, steps)
        nn = n_nodes + d
        parent[rows, n1] = torch.where(do, nn.to(i32), parent[rows, n1])
        parent[rows, n2] = torch.where(do, nn.to(i32), parent[rows, n2])
        w1, w2 = weight[rows, n1], weight[rows, n2]
        packed = (((w1 & ~0xFF) + (w2 & ~0xFF))
                  | (1 + torch.maximum(w1 & 0xFF, w2 & 0xFF)))
        weight[rows, nn] = torch.where(do, packed, weight[rows, nn])
        nh = nh + d
        _upheap(heap, weight, rows, nh, nn, do, steps)
        n_heap, n_nodes = nh, nn

    # node depths by pointer doubling on the parent forest
    jump = parent.to(torch.int64)
    cnt = (parent >= 0).to(i32)
    for _ in range(_CHAIN_DOUBLINGS):
        has = jump >= 0
        j2 = torch.where(has, jump, 0)
        cnt = cnt + torch.where(has, torch.gather(cnt, 1, j2), 0)
        jump = torch.where(has, torch.gather(jump, 1, j2), -1)
    lens = cnt[:, 1:A + 1]
    leaf = torch.arange(A, device=dev)[None, :] < alpha[:, None]
    return lens, (leaf & (lens > MAX_LEN)).any(dim=1)


def make_code_lengths_lanes_plain(freq: torch.Tensor,
                                  alpha: torch.Tensor) -> torch.Tensor:
    """freq (L, 258) int32, alpha (L,) int32 -> lens (L, 258) int32.  Each
    retry rebuilds only the lanes still too long; a lane stops after
    ``MAX_HALVINGS`` halvings whatever its depth, as JAX's does."""
    L = freq.shape[0]
    if L == 0:
        return torch.zeros((0, A), dtype=torch.int32, device=freq.device)
    alpha = alpha.to(torch.int32)
    wl = torch.zeros((L, A + 1), dtype=torch.int32, device=freq.device)
    wl[:, 1:] = torch.where(freq == 0, 1, freq).to(torch.int32) << 8
    lens, too_long = _attempt(wl, alpha)
    for _ in range(MAX_HALVINGS):
        idx = torch.nonzero(too_long).flatten()
        if idx.numel() == 0:
            break
        sub = (1 + ((wl[idx] >> 8) // 2)) << 8
        sub[:, 0] = 0
        wl[idx] = sub
        lens[idx], too_long[idx] = _attempt(sub, alpha[idx])
    return lens


def make_code_lengths_lanes(freq: torch.Tensor,
                            alpha: torch.Tensor) -> torch.Tensor:
    """freq (L, 258) int32, alpha (L,) int32 -> lens (L, 258) int32 (see
    the module note).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, one block a lane."""
    if freq.dim() != 2 or freq.shape[1] != A or alpha.shape != freq.shape[:1]:
        raise ValueError(f"make_code_lengths_lanes: shapes {tuple(freq.shape)}"
                         f" {tuple(alpha.shape)}")
    if freq.device.type == "cpu":
        return make_code_lengths_lanes_plain(freq, alpha)
    _build.check(freq, "make_code_lengths_lanes freq", torch.int32, 2)
    _build.check(alpha, "make_code_lengths_lanes alpha", torch.int32, 1)
    L = freq.shape[0]
    out = torch.empty_like(freq)
    if L:
        KERNEL(_build.ptr(freq), _build.ptr(alpha), _build.ptr(out), L,
               _build.stream_of(freq))
    return out


def assign_codes_lanes(lens: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Canonical code assignment (huffman.c:152-166), vectorised over lanes.
    lens: (L, A) int32 (entries >= alpha ignored); alpha: (L,).
    Returns codes (L, A) int32."""
    L = lens.shape[0]
    dev = lens.device
    i32 = torch.int32
    active = torch.arange(A, device=dev)[None, :] < alpha[:, None]
    lens_m = torch.where(active, lens, 0).to(torch.int64)
    onehot = (lens_m[:, :, None]
              == torch.arange(24, device=dev)[None, None, :]).to(i32)
    counts = onehot.sum(dim=1, dtype=i32)                      # (L, 24)
    counts[:, 0] = 0           # pseudo-length 0 marks inactive symbols
    # first[l] = (first[l-1] + counts[l-1]) << 1, first[0] = 0
    first = torch.zeros((L, 24), dtype=i32, device=dev)
    fc = torch.zeros(L, dtype=i32, device=dev)
    for ln in range(24):
        first[:, ln] = fc
        fc = (fc + counts[:, ln]) << 1
    # rank within the same length, by symbol order
    within = torch.cumsum(onehot, dim=1, dtype=i32) - 1         # (L, A, 24)
    rank = torch.gather(within, 2, lens_m[:, :, None])[:, :, 0]
    code = torch.gather(first, 1, lens_m) + rank
    return torch.where(active, code, 0)
