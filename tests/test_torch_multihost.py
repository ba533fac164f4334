"""The port's multi-process layer (bzip2_tpu_torch/parallel/multihost.py)
on Gloo over localhost, as tests/test_multihost.py runs the JAX one: the
stream a group of ranks encodes from its shards equals bz2.compress of the
whole input, and the member-grain decode returns the input exactly.

The workers are real processes started with ``-c``; they import only
torch, numpy and the port, and each has a two-entry CPU mesh
(``device="cpu"``).  The pytest process itself never joins a process
group.  Every wait on a worker has its own timeout."""
import bz2 as stdlib_bz2
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bzip2_tpu_torch.parallel import multihost as MH
from test_torch_fuzz import _randomised_stream

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 240

WORKER = r"""
import bz2, json, os, sys
pid, H, port, tmp, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
import torch.distributed as dist
from bzip2_tpu_torch.parallel import multihost
multihost.initialize("127.0.0.1:" + port, num_processes=H, process_id=pid,
                     local_device_count=2, device="cpu")
cfg = json.load(open(os.path.join(tmp, "cfg.json")))
data = open(os.path.join(tmp, "input.bin"), "rb").read()
cuts = [0] + cfg["cuts"] + [len(data)]
level = cfg["level"]
shard = data[cuts[pid]:cuts[pid + 1]]
res = {}
if cfg.get("fault") == pid:
    def boom(*a, **k):
        raise RuntimeError("injected fault")
    multihost.encode_blocks_sharded = multihost.decode_blocks_sharded = boom
if cfg.get("fault") is not None:
    stream = open(os.path.join(tmp, "members.bz2"), "rb").read()
    for key, call in (
            ("encode", lambda: multihost.compress_sharded(shard, level)),
            ("gpu", lambda: multihost.decompress_members(stream, "gpu"))):
        try:
            call()
            res[key] = None
        except RuntimeError as e:
            res[key] = str(e)
    dist.destroy_process_group()
    print(json.dumps(res))
    sys.exit(0)
out = multihost.compress_sharded(shard, level=level)
if pid == 0:
    res["encode"] = out == bz2.compress(data, level)
else:
    res["encode"] = out is None
if cfg.get("members"):
    stream = open(os.path.join(tmp, "members.bz2"), "rb").read()
    want = open(os.path.join(tmp, "members.raw"), "rb").read()
    for backend in ("gpu", "native"):
        dec = multihost.decompress_members(stream, backend=backend)
        res[backend] = dec == want if pid == 0 else dec is None
if cfg.get("corrupt"):
    bad = open(os.path.join(tmp, "corrupt.bz2"), "rb").read()
    try:
        multihost.decompress_members(bad, backend="gpu")
        res["corrupt"] = None
    except ValueError as e:
        res["corrupt"] = str(e)
dist.destroy_process_group()
print(json.dumps(res))
"""


def _run(tmp_path, data: bytes, cuts: list, level: int, members=None,
         corrupt=None, fault=None):
    """Run len(cuts) + 1 ranks over ``data`` cut at ``cuts``, then decode
    ``members`` (stream, want) and ``corrupt``; returns each rank's result
    dict.  With ``fault`` set to a rank, that rank's mesh encode and decode
    raise RuntimeError, and every rank reports the error each of the two
    calls raised there."""
    (tmp_path / "input.bin").write_bytes(data)
    cfg = {"cuts": cuts, "level": level, "members": members is not None,
           "corrupt": corrupt is not None, "fault": fault}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    if members is not None:
        (tmp_path / "members.bz2").write_bytes(members[0])
        (tmp_path / "members.raw").write_bytes(members[1])
    if corrupt is not None:
        (tmp_path / "corrupt.bz2").write_bytes(corrupt)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "JAX_PLATFORMS")}
    H = len(cuts) + 1
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), str(H), str(port),
         str(tmp_path), str(REPO)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(H)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
        results.append(json.loads(so.decode().strip().splitlines()[-1]))
    return results


def test_two_ranks_encode_and_member_decode(tmp_path, golden):
    """The input of tests/test_multihost.py, cut in the middle of a long
    run (the split relay carries RLE1 state across the cut), at level 1;
    then a three-member stream decoded on the ranks' CPU meshes and on the
    host."""
    data = golden[2][0] + b"x" * 600 + golden[2][0][:120_000]
    cut = len(golden[2][0]) + 300
    members = (stdlib_bz2.compress(data[:50_000], 1)
               + stdlib_bz2.compress(b"second member", 9)
               + stdlib_bz2.compress(data[50_000:], 1))
    want = data[:50_000] + b"second member" + data[50_000:]
    res = _run(tmp_path, data, [cut], 1, members=(members, want))
    assert res == [{"encode": True, "gpu": True, "native": True}] * 2


def test_randomised_member_to_host_and_corrupt_member_raises(tmp_path,
                                                            golden):
    """A legacy randomised member among regular ones: with backend "gpu"
    the rank that holds it decodes it on the host, the others on their
    meshes; the output is exact on both backends.  A corrupt member raises
    its ValueError on the rank that holds it and on rank 0, and no rank
    hangs."""
    raw = golden[1][0][:40_000]
    m0 = stdlib_bz2.compress(golden[2][0], 1)
    m2 = stdlib_bz2.compress(golden[3][0], 1)
    members = m0 + _randomised_stream(raw) + m2
    want = golden[2][0] + raw + golden[3][0]
    assert stdlib_bz2.decompress(members) == want
    m1 = bytearray(stdlib_bz2.compress(raw, 1))
    m1[len(m1) // 2] ^= 0x40
    res = _run(tmp_path, raw, [20_000], 1, members=(members, want),
               corrupt=m0 + bytes(m1) + m2)
    for r in res:
        assert {k: r[k] for k in ("encode", "gpu", "native")} == {
            "encode": True, "gpu": True, "native": True}
        assert r["corrupt"] is not None and "block" in r["corrupt"], r


def test_two_ranks_periodic_shards_equal_stock(tmp_path):
    """Exactly periodic blocks on both ranks: the device sort's tie slot
    differs from stock's origPtr on the two 99,981-byte blocks of this
    input, so each rank corrects its payloads before the gather, and the
    stream equals bz2.compress."""
    data = b"bba" * 70_000                # blocks of 99,981, 99,981, 10,038
    assert _run(tmp_path, data, [150_000], 1) == [{"encode": True}] * 2


def test_any_error_on_one_rank_reaches_rank_0(tmp_path, golden):
    """A RuntimeError in rank 1's local mesh encode, then in its member
    decode: rank 1 raises it, rank 0 raises it from the gather, and
    neither waits in a collective."""
    data = golden[2][0] + golden[1][0]
    members = (stdlib_bz2.compress(golden[1][0], 1)
               + stdlib_bz2.compress(golden[2][0], 1))
    res = _run(tmp_path, data, [len(golden[2][0]) // 2], 1,
               members=(members, golden[1][0] + golden[2][0]), fault=1)
    assert res == [{"encode": "injected fault", "gpu": "injected fault"}] * 2


@pytest.mark.parametrize("empty", ["first", "last"])
def test_three_ranks_short_and_empty_shards(tmp_path, golden, empty):
    """Three ranks; the middle shard is shorter than one block and one
    shard is empty, so a carry crosses a rank with no closed block."""
    data = golden[1][0] + golden[2][0]
    if empty == "first":
        cuts = [0, 30_000]                      # "", 30 KB, the rest
    else:
        cuts = [len(data) - 30_000, len(data)]  # the rest, 30 KB, ""
    res = _run(tmp_path, data, cuts, 1)
    assert res == [{"encode": True}] * 3


def test_unknown_backend_raises():
    """The backend is checked before any collective; the JAX layer's
    "device" is the port's "gpu"."""
    comp = stdlib_bz2.compress(b"abc", 1)
    for name in ("device", "tpu", "bogus"):
        with pytest.raises(ValueError, match="unknown backend"):
            MH.decompress_members(comp, backend=name)


def test_initialize_needs_cuda_unless_cpu_is_named():
    """Checked before the process group is joined: without CUDA the
    default raises, a device other than "cuda" or "cpu" is refused, and
    no mesh is set."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        MH.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="device"):
        MH.initialize("127.0.0.1:1", 1, 0, device="tpu")
    with pytest.raises(RuntimeError, match="initialize"):
        MH.local_mesh()


def test_single_rank_group_is_one_process_encode(tmp_path, golden):
    """One rank: compress_sharded is the one-process encode."""
    data = golden[3][0][:60_000] + bytes(np.arange(256, dtype=np.uint8)) * 40
    assert _run(tmp_path, data, [], 2) == [{"encode": True}]
