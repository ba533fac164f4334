"""The port's bench (``python -m bzip2_tpu_torch.bench``) on the CPU.

Its corpus equals the root ``bench.make_corpus`` byte for byte, on the
walk of the installed Python sources and on the golden-mix fallback; the
reference runs from a copy in ``tmp_path`` (with ``tests/`` linked beside
it), so that neither result reads a cache file left by another run.  The
bench itself runs with ``--device cpu`` at 512 KiB and -1: exact, with the
four keys of the reference's result line; ``--backend native`` runs the
host engine alone; and without CUDA the module exits non-zero and prints
no result line.
"""
import glob
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from bzip2_tpu_torch import bench, engine

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _reference_bench(tmp_path):
    """The root bench.py loaded from a copy in ``tmp_path``: its cache
    (``.bench_corpus.bin`` beside the file) starts absent."""
    shutil.copy(ROOT / "bench.py", tmp_path / "bench.py")
    (tmp_path / "tests").symlink_to(ROOT / "tests")
    spec = importlib.util.spec_from_file_location(
        "reference_bench_copy", tmp_path / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("source,size", [
    ("walk", 1 << 20), ("walk", 1_234_567),
    ("fallback", 1 << 20), ("fallback", 654_321)])
def test_make_corpus_equals_the_reference(tmp_path, monkeypatch, source,
                                          size):
    (tmp_path / "ref").mkdir()
    ref = _reference_bench(tmp_path / "ref")
    if source == "fallback":
        monkeypatch.setattr(glob, "glob", lambda *a, **k: [])
    cache = tmp_path / "port" / "corpus.bin"
    info: dict = {}
    got = bench.make_corpus(size, cache=str(cache), info=info)
    assert len(got) == size
    assert got == ref.make_corpus(size)
    if source == "fallback":
        assert info == {"source": "walk+fallback", "files": 0,
                        "walk_bytes": 0}
        assert bench.fallback_share(got, info) == 1.0
        assert not cache.exists()           # only a full walk is cached
    else:
        assert info["source"] == "walk" and info["files"] > 0
        again: dict = {}
        assert bench.make_corpus(size - 1000, cache=str(cache),
                                 info=again) == got[:-1000]
        assert again == {"source": "cache", "files": info["files"],
                         "walk_bytes": size}
        assert bench.fallback_share(got, info) == 0.0


def _run_main(monkeypatch, capsys, argv):
    monkeypatch.setenv("BENCH_BYTES", str(512 << 10))
    monkeypatch.setenv("BENCH_LEVEL", "1")
    monkeypatch.setenv("BENCH_ROUNDS", "1")
    assert bench.main(argv) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_bench_on_the_cpu_is_exact_and_prints_the_result_line(monkeypatch,
                                                              capsys):
    line, err = _run_main(monkeypatch, capsys, ["--device", "cpu"])
    assert set(line) == KEYS
    assert line["unit"] == "MB/s" and line["value"] > 0
    assert line["vs_baseline"] > 0
    assert "bit-exact=True" in line["metric"] and "at -1" in line["metric"]
    assert "bzip2_tpu_torch.decompress on cpu" in line["metric"]
    assert "% golden fallback" in line["metric"]
    assert "corpus walk" in line["metric"] or "corpus cache" in line["metric"]
    for text in ("stock bz2 -1", "round 0:", "median", "card: cpu",
                 "sha256", "decoder stage walls"):
        assert text in err


def test_native_backend_is_host_only(monkeypatch, capsys):
    calls = []
    real = engine.Engine.encode_batch
    monkeypatch.setattr(engine.Engine, "encode_batch",
                        lambda self, *a: calls.append(a) or real(self, *a))
    res = bench.run(size=300_000, level=1, rounds=1, device="cpu",
                    backend="native")
    assert calls == []
    assert res["share"]["dev_blocks"] == 0
    assert res["share"]["host_blocks"] == res["share"]["blocks"] > 0
    assert "decode" not in res
    assert set(res["json"]) == KEYS
    assert "host-only" in res["json"]["metric"]


def test_without_cuda_the_module_exits_nonzero_with_no_result():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               BENCH_BYTES="100000", BENCH_LEVEL="1", BENCH_ROUNDS="1")
    r = subprocess.run([sys.executable, "-m", "bzip2_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA is not available" in r.stderr
