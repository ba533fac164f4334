"""Multi-process block-parallel encode and member-grain decode on
``torch.distributed`` (port of ``bzip2_tpu/parallel/multihost.py``).

Every collective moves host bytes: the raw tail one rank relays to the
next, and each rank's block payloads and CRCs, which are on the host for
the splice anyway.  So the process group
is Gloo: NCCL would add device copies, and it cannot put two ranks on one
card.

Encode (every rank runs the same program):

1. **Split relay.** The global block split is sequential at RLE1-segment
   grain, but only the split is: rank h splits ``carry + shard`` and relays
   the raw tail of its last, unclosed block to rank h+1.  Blocks close at
   segment boundaries (bzlib.c:276-308), so the carry starts in a clean
   RLE1 state and the local splits reproduce the one-process split.
2. **Local encode.** Each rank encodes its closed blocks on its local mesh
   (``mesh.encode_blocks_sharded``).
   Its payloads pass through the exactly-periodic origPtr corrector
   (``periodic.patch_payloads``), as every one-process encode's do.
3. **Ordered gather and splice.** Rank 0 gathers each rank's payloads and
   block CRCs in rank order and frames them (``api.frame``: header,
   splice, end-of-stream magic and combined CRC).

Decode: member grain.  Each rank decodes its round-robin share of the
stream's members; rank 0 gathers the outputs in member order.

An error that one rank meets in its local work travels to rank 0 in the
gather, so the rank that met it and rank 0 both raise it and no rank waits
in a collective for a rank that has stopped.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from .. import periodic
from .. import rle1 as _rle1
from ..api import frame
from ..engine import (_block_pad_size, _words_for, batch_arrays,
                      payloads_from_words)
from .decode import find_member_offsets
from .mesh import (RandomisedBlockError, decode_blocks_sharded,
                   encode_blocks_sharded, make_mesh)

#: this process's local mesh, set by initialize()
_local: dict = {"mesh": None}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None,
               device: str = "cuda") -> None:
    """Join the Gloo process group at ``coordinator_address``
    (``host:port``) and set this process's local mesh: ``cuda:0`` ..
    ``cuda:k-1`` (k defaults to every CUDA device; without CUDA this
    raises), or k CPU entries (default 1) when ``device="cpu"``."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: CUDA is not available; pass "
                               "device='cpu' to use the CPU")
        k = (torch.cuda.device_count() if local_device_count is None
             else local_device_count)
        if not 1 <= k <= torch.cuda.device_count():
            raise ValueError(f"initialize: {k} local devices, "
                             f"{torch.cuda.device_count()} CUDA devices")
        mesh = make_mesh([f"cuda:{i}" for i in range(k)])
    elif device == "cpu":
        mesh = make_mesh(["cpu"] * (local_device_count or 1))
    else:
        raise ValueError(f"initialize: device must be 'cuda' or 'cpu', "
                         f"not {device!r}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _local["mesh"] = mesh


def local_mesh():
    """The mesh ``initialize`` set for this process."""
    if _local["mesh"] is None:
        raise RuntimeError("multihost.initialize has not been called")
    return _local["mesh"]


def _bcast_bytes(data: bytes, src: int) -> bytes:
    """Broadcast a variable-length byte string from rank ``src``: its
    length first, then its bytes."""
    is_src = dist.get_rank() == src
    n = torch.tensor([len(data) if is_src else 0], dtype=torch.int64)
    dist.broadcast(n, src)
    ln = int(n[0])
    if is_src:
        buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    else:
        buf = torch.empty(ln, dtype=torch.uint8)
    if ln:
        dist.broadcast(buf, src)
    return buf.numpy().tobytes()


def _portable(err: Exception) -> Exception:
    """``err``, or a RuntimeError that names it if it does not pickle."""
    try:
        pickle.dumps(err)
        return err
    except Exception:  # noqa: BLE001 -- any pickling failure
        return RuntimeError(f"{type(err).__name__}: {err}")


def _gather_to_root(work, err: Exception | None = None):
    """Run this rank's local ``work()`` (unless ``err`` is already set) and
    gather its result, or the error it raised, to rank 0 in rank order.
    The rank that met an error raises it after the gather, and rank 0
    raises the first error of any rank.  Returns the list of results on
    rank 0, None elsewhere."""
    if err is None:
        try:
            local = work()
        except Exception as e:  # noqa: BLE001 -- re-raised after the gather
            err = e
    if err is not None:
        local = _portable(err)
    pid = dist.get_rank()
    gathered = [None] * dist.get_world_size() if pid == 0 else None
    dist.gather_object(local, gathered, dst=0)
    if err is not None:
        raise err
    if pid != 0:
        return None
    for part in gathered:
        if isinstance(part, Exception):
            raise part
    return gathered


def compress_sharded(shard: bytes, level: int = 9) -> bytes | None:
    """Encode this rank's raw ``shard`` of a global input; returns the whole
    .bz2 stream on rank 0 (None elsewhere), bit-exact with a one-process
    encode of the concatenated shards."""
    pid = dist.get_rank()
    H = dist.get_world_size()

    # --- 1. split relay
    my_blocks = []
    carry = b""
    err = None
    for h in range(H):
        tail = b""
        if pid == h:
            try:
                buf = carry + bytes(shard)
                blocks = _rle1.encode_blocks(buf, level)
                if h == H - 1:
                    my_blocks = blocks
                else:
                    # hold back the last block: its contents (and the EOS
                    # epilogue) may change with the next shard's bytes
                    my_blocks = blocks[:-1] if len(blocks) > 1 else []
                    tail = buf[my_blocks[-1].raw_span[1] if my_blocks else 0:]
            except Exception as e:  # noqa: BLE001 -- raised after the gather
                err = e
        if h < H - 1:
            carry = _bcast_bytes(tail, src=h)

    # --- 2. local encode to final payloads
    def encode():
        if not my_blocks:
            return [], []
        N = _block_pad_size(level)
        words, nbits = encode_blocks_sharded(
            local_mesh(), *batch_arrays(my_blocks, len(my_blocks), N),
            _words_for(N))
        payloads = periodic.patch_payloads(payloads_from_words(words, nbits),
                                           my_blocks, level)
        return payloads, [b.crc for b in my_blocks]

    # --- 3. ordered gather and framing on rank 0
    gathered = _gather_to_root(encode, err)
    if gathered is None:
        return None
    return frame([c for _p, crcs in gathered for c in crcs],
                 [p for payloads, _c in gathered for p in payloads], level)


def decompress_members(stream: bytes, backend: str = "native") -> bytes | None:
    """Member-grain decode: each rank decodes its round-robin share of the
    concatenated stream's members; rank 0 returns the whole output (None
    elsewhere).

    ``backend="gpu"`` decodes each local member's blocks on the local mesh
    (``mesh.decode_blocks_sharded``: block-parallel inside a member,
    member-parallel across ranks); only a member with a legacy randomised
    block goes to the host, and a corrupt member raises its ValueError.
    ``"native"`` decodes on the host (``native.decompress``)."""
    if backend not in ("gpu", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    pid = dist.get_rank()
    H = dist.get_world_size()
    starts = find_member_offsets(stream)
    spans = list(zip(starts, starts[1:] + [len(stream)]))

    def decode():
        return {i: _decode_member(i, stream[start:end], backend)
                for i, (start, end) in enumerate(spans) if i % H == pid}

    gathered = _gather_to_root(decode)
    if gathered is None:
        return None
    merged = {}
    for part in gathered:
        merged.update(part)
    return b"".join(merged[i] for i in range(len(spans)))


def _decode_member(i: int, member: bytes, backend: str) -> bytes:
    if backend == "gpu":
        try:
            return decode_blocks_sharded(local_mesh(), member)
        except RandomisedBlockError:
            pass            # the mesh decodes no randomised block
    out, _, rc = native.decompress(member)
    if out is None:
        raise ValueError(f"member {i} corrupt (rc={rc})")
    return out
