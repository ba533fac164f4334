"""The port's measurement tools (``bzip2_tpu_torch/tools``) on the CPU.

``spew_chunks`` equals the reference tool's bytes; the spew round trip
through ``BZ2TFile`` and the -1..-9 matrix are exact on a CPU engine
registered as "gpu" (every block on it); each tool's ``main`` runs with
``--device cpu`` at a tiny size, and exits non-zero without it when there
is no CUDA; ``bwt_stats``' per-round counts of unresolved positions equal
a direct count of the rotations whose k-byte prefixes repeat; and the
reference's ``tools/bzgrep``, pointed by ``$BZ2T`` at the port's CLI,
finds a line in a ``.bz2`` the port wrote.
"""
import bz2
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bzip2_tpu_torch import api, decoder, engine
from bzip2_tpu_torch.tools import (bwt_stats, gather_probe, mesh_bench,
                                   probe_stages, profile_device, sais_probe,
                                   sanitize, scale_bench, scaling_bench,
                                   span_idle)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture
def cpu_gpu_entry(monkeypatch):
    """``scale_bench.setup`` on the CPU with no host worker; the registry's
    "gpu" entry and the default decoder are restored afterwards."""
    monkeypatch.delitem(api._BLOCK_ENCODERS, "gpu", raising=False)
    monkeypatch.setattr(decoder, "_default", None)
    return scale_bench.setup("cpu", "gpu", host_workers=0)


def test_spew_chunks_equal_the_reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_scale_bench", ROOT / "tools" / "scale_bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for total, chunk in ((3_500_000, 1 << 20), (9 << 20, 8 << 20)):
        got = list(scale_bench.spew_chunks(total, chunk))
        assert got == list(ref.spew_chunks(total, chunk))
        assert sum(map(len, got)) == total


def test_spew_round_trip_through_the_file_api(cpu_gpu_entry, tmp_path):
    res = scale_bench.bench_spew(250_000, str(tmp_path / "spew.bz2"), "gpu",
                                 cpu_gpu_entry, level=1)
    assert res["bytes"] == 250_000
    sh = res["share"]
    assert sh["dev_blocks"] == sh["blocks"] == 3 and sh["host_blocks"] == 0
    assert res["bwt_batches"] >= 1 and res["bwt_full_rounds"] > 0
    assert not (tmp_path / "spew.bz2").exists()


def test_level_matrix_is_exact_at_every_level(cpu_gpu_entry):
    rng = np.random.default_rng(9)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    data = b" ".join(words[i] for i in rng.integers(0, 6, 13_000))[:64 << 10]
    rows = scale_bench.level_matrix(data, range(1, 10), "gpu", cpu_gpu_entry)
    assert [r["level"] for r in rows] == list(range(1, 10))
    for r in rows:
        assert r["share"]["dev_blocks"] == r["share"]["blocks"] == 1
        assert r["batches"] == [(1, engine._block_pad_size(r["level"]))]


TOOLS = {
    "scale_bench": (scale_bench, ["--device", "cpu", "--host-workers", "0",
                                  "--small"]),
    "mesh_bench": (mesh_bench, ["1", "--device", "cpu", "--level", "1",
                                "--blocks", "1", "--decode-bytes", "120000"]),
    "scaling_bench": (scaling_bench, ["--device", "cpu", "--entries", "1,2",
                                      "--per-entry", "1"]),
    "probe_stages": (probe_stages, ["--device", "cpu", "--level", "1",
                                    "--blocks", "1", "--reps", "1",
                                    "--transfer-bytes", "4096"]),
    "profile_device": (profile_device, ["bwt", "iter", "post", "decode",
                                        "encode", "--device", "cpu",
                                        "--level", "1", "--blocks", "1",
                                        "--reps", "1", "--bytes", "150000"]),
    "bwt_stats": (bwt_stats, ["--device", "cpu", "--level", "1",
                              "--blocks", "1"]),
    "gather_probe": (gather_probe, ["--device", "cpu", "--rows", "2", "--n",
                                    "4096", "--reps", "2"]),
    "sais_probe": (sais_probe, ["200000", "--device", "cpu"]),
    "sanitize": (sanitize, ["undefined", "--device", "cpu", "--scale", "1",
                            "--corrupt", "3"]),
    "span_idle": (span_idle, ["--device", "cpu", "--level", "1",
                              "--object-mib", "0.15", "--seconds", "0",
                              "--round-hook"]),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_main_runs_on_the_cpu(name, monkeypatch):
    monkeypatch.delitem(api._BLOCK_ENCODERS, "gpu", raising=False)
    monkeypatch.setattr(decoder, "_default", None)
    # --small at a CPU test's size: one -9 block each
    monkeypatch.setattr(scale_bench, "SMALL_BYTES", 150_000)
    monkeypatch.setattr(scale_bench, "SMALL_SPEW", 150_000)
    mod, argv = TOOLS[name]
    res = mod.main(argv)
    assert isinstance(res, dict) and res


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_cuda_exits_nonzero(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = TOOLS[name]
    cuda_argv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit) as exc:
        mod.main(cuda_argv)
    assert exc.value.code not in (0, None)
    assert "CUDA is not available" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def _tied(block: bytes, k: int) -> int:
    """Positions whose cyclic k-byte prefix occurs at another position."""
    n = len(block)
    doubled = block * (k // n + 2)
    prefixes = [doubled[i:i + k] for i in range(n)]
    seen: dict = {}
    for p in prefixes:
        seen[p] = seen.get(p, 0) + 1
    return sum(1 for p in prefixes if seen[p] > 1)


def test_bwt_stats_counts_equal_a_direct_count():
    rng = np.random.default_rng(3)
    # a text with long repeats: several doubling rounds and tail stages
    unit = rng.integers(97, 100, 300, dtype=np.uint8).tobytes()
    blocks = [unit * 3 + b"xyz" + unit[:200] * 2 + b"q",
              rng.integers(97, 99, 1500, dtype=np.uint8).tobytes()]
    N = 2048
    arr = np.zeros((2, N), np.uint8)
    for j, b in enumerate(blocks):
        arr[j, :len(b)] = np.frombuffer(b, np.uint8)
    ns = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    rows = bwt_stats.trajectory(torch.from_numpy(arr), ns)
    assert rows[0][:2] == (0, 16)
    assert [k for _s, k, _u in rows] == [16 << i for i in range(len(rows))]
    assert {s for s, _k, _u in rows} > {0}          # tail stages ran
    for _stage, k, unres in rows:
        assert unres == [_tied(b, k) for b in blocks], k
    assert rows[-1][2] == [0, 0]


def test_bzgrep_through_the_port_cli(tmp_path):
    text = b"".join(b"line %d of the port\n" % i for i in range(5000))
    path = tmp_path / "t.bz2"
    path.write_bytes(api.compress(text, 9, backend="native"))
    assert bz2.decompress(path.read_bytes()) == text
    exe = tmp_path / "bz2t-port"
    exe.write_text(f"#!/bin/sh\nexec {sys.executable} -m "
                   'bzip2_tpu_torch.cli --backend=native "$@"\n')
    exe.chmod(0o755)
    env = dict(os.environ, BZ2T=str(exe), PYTHONPATH=str(ROOT))
    r = subprocess.run(["sh", str(ROOT / "tools" / "bzgrep"), "line 4321 of",
                        str(path)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "line 4321 of the port\n"
    r = subprocess.run(["sh", str(ROOT / "tools" / "bzgrep"), "no such line",
                        str(path)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and r.stdout == ""
