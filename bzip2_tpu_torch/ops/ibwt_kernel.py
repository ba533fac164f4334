"""Inverse-BWT splitter walk: wrapper of the CUDA kernel in
``csrc/ibwt_walk.cu`` and its plain PyTorch version.

Counterpart of the ``wave`` loop of ``bzip2_tpu/ops/decode.py:ibwt``, a
``lax.while_loop`` that has no Pallas original.  Each (block, walker) lane
chases the packed successor array ``tt = succ << 9 | splitter << 8 | byte``
from its start position until it reaches a splitter or ``cap`` steps pass.
The plain version is that loop in torch ops, one host check per step; the
kernel runs every lane to its end in one launch and writes the whole
buffer, zero tails included.  A wrapper runs its plain version only for a
tensor on the CPU; for a CUDA tensor it launches its kernel.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build

WALK = _build.Kernel("ibwt_walk", "bz2t_ibwt_walk",
                     [ct.c_void_p] * 6 + [ct.c_int] * 4 + [ct.c_void_p])


def ibwt_walk_plain(tt: torch.Tensor, cur0: torch.Tensor, cap: int):
    """The reference's loop: every step advances all active lanes and stops
    once no lane is active or ``cap`` steps have passed."""
    B, N = tt.shape
    W = cur0.shape[1]
    dev = tt.device
    cur = cur0.clone()
    cnt = torch.zeros((B, W), dtype=torch.int32, device=dev)
    hitp = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    buf = torch.zeros((B, W, cap), dtype=torch.uint8, device=dev)
    t = 0
    while t < cap and bool((cur >= 0).any()):
        active = cur >= 0
        v = torch.gather(tt, 1, cur.clamp(0, N - 1).to(torch.int64))
        nxt = v >> 9
        done = active & ((v & 0x100) != 0)
        hitp = torch.where(done, nxt, hitp)
        cnt += active.to(torch.int32)
        cur = torch.where(active & ~done, nxt, -1)
        buf[:, :, t] = torch.where(active, v & 0xFF, 0).to(torch.uint8)
        t += 1
    return cur, cnt, hitp, buf


def ibwt_walk(tt: torch.Tensor, cur0: torch.Tensor, cap: int):
    """tt: (B, N) int32 packed successors; cur0: (B, W) int32 start
    positions, -1 for inactive lanes.  Returns (cur, cnt, hitp, buf):
    cur (B, W) int32 is -1 for a lane that reached a splitter and its next
    position for one stopped by ``cap``; cnt (B, W) int32 the steps taken;
    hitp (B, W) int32 the splitter position reached, or -1; buf (B, W, cap)
    uint8 the bytes emitted, 0 past a lane's last step."""
    if (tt.dim() != 2 or cur0.dim() != 2 or cur0.shape[0] != tt.shape[0]
            or cap < 1):
        raise ValueError(f"ibwt_walk: shapes {tuple(tt.shape)} "
                         f"{tuple(cur0.shape)}, cap {cap}")
    if tt.device.type == "cpu":
        return ibwt_walk_plain(tt, cur0, cap)
    _build.check(tt, "ibwt_walk tt", torch.int32, 2)
    _build.check(cur0, "ibwt_walk cur0", torch.int32, 2)
    B, N = tt.shape
    W = cur0.shape[1]
    cur = torch.empty_like(cur0)
    cnt = torch.empty_like(cur0)
    hitp = torch.empty_like(cur0)
    buf = torch.empty((B, W, cap), dtype=torch.uint8, device=tt.device)
    WALK(_build.ptr(tt), _build.ptr(cur0), _build.ptr(cur), _build.ptr(cnt),
         _build.ptr(hitp), _build.ptr(buf), B, N, W, cap,
         _build.stream_of(tt))
    return cur, cnt, hitp, buf
