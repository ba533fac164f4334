"""Whole runs of the harness on the CPU at a tiny size, the card's look
skipped (``run_cell`` with the port on the CPU): the result line's keys,
and ``correct`` false under the control and under each fault a compress
or decompress cell can have (an answer altered where it is produced; half
of a device batch left out)."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from portbench import cells, run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "host",
        "checks"}


def _cell(op="compress"):
    cell = cells.load("bzip2-9.compress-text")
    cell.config = dict(cell.config, level=1)
    # two 100k blocks an object: one batch of two rows
    cell.traffic = dict(cell.traffic, op=op, object_bytes=150_000,
                        clients=2, pool=2)
    if op == "decompress":
        cell.end_to_end = [{"name": "decompress_MBps", "unit": "MB/s"},
                           {"name": "setup_s", "unit": "s"}]
    return cell


def _run(cell, traced=False, control=False):
    res = run.run_cell(cell, 2 ** 31 + 5, 0.5, traced,
                       extra={"device": "cpu"}, control=control)
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.emit(res)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


def test_sound_run_line_has_the_keys():
    line = _run(_cell())
    assert set(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    assert set(line["metrics"]) == {"compress_MBps", "compress_p95_ms",
                                    "setup_s"}
    assert all(set(v) == {"value", "limit"}
               for v in line["checks"].values())
    assert line["host"]["probe_ms_per_MiB"] > 0


def test_traced_line_has_breakdown():
    line = _run(_cell(), traced=True)
    assert set(line) == KEYS | {"breakdown"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["correct"] is True
    # per-layer metrics only: no end-to-end metric in a traced line
    assert "compress_MBps" not in line["metrics"]


def test_control_is_not_correct():
    line = _run(_cell(), control=True)
    assert line["correct"] is False
    assert line["checks"]["wrong_outputs"]["value"] >= 1


def test_answer_altered_is_not_correct(monkeypatch):
    from bzip2_tpu_torch import engine

    inner = engine.payloads_from_words

    def altered(words, nbits):
        out = inner(words, nbits)
        by, nb = out[0]
        by = by.copy()
        by[len(by) // 2] ^= 0x10
        return [(by, nb)] + out[1:]

    monkeypatch.setattr(engine, "payloads_from_words", altered)
    line = _run(_cell())
    assert line["correct"] is False


def test_half_batch_left_out_is_not_correct(monkeypatch):
    from bzip2_tpu_torch import engine

    inner = engine.Engine.encode_batch

    def half(self, level, arr, ns, uses, crcs):
        h = max(1, arr.shape[0] - arr.shape[0] // 2)
        words, nbits = inner(self, level, arr[:h], ns[:h], uses[:h],
                             crcs[:h])
        idx = np.arange(arr.shape[0]) % h       # the rest reuse the half
        return words[idx], nbits[idx]

    monkeypatch.setattr(engine.Engine, "encode_batch", half)
    line = _run(_cell())
    assert line["correct"] is False


def test_decompress_sound_control_and_altered(monkeypatch):
    cell = _cell("decompress")
    assert _run(cell)["correct"] is True
    assert _run(cell, control=True)["correct"] is False
    from bzip2_tpu_torch import decoder

    inner = decoder.DeviceDecoder.decompress_with_tail

    def altered(self, data, multi_stream=True):
        out, n = inner(self, data, multi_stream)
        return out[:-1] + bytes([out[-1] ^ 1]), n

    monkeypatch.setattr(decoder.DeviceDecoder, "decompress_with_tail",
                        altered)
    assert _run(cell)["correct"] is False


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "bzip2-9.compress-text", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _cli(cells.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil
    shutil.copytree(os.path.join(cells.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cli(str(tmp_path), env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
