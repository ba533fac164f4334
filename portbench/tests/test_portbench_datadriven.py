"""A configuration, a traffic mix, a kind of data, an operation, an
end-to-end and a per-layer metric and a cell are added by adding files and
entries alone: a fixture of each, in a temporary copy of the benchmark, is
found and run with no file of the harness edited."""
import hashlib
import json
import os
import shutil

import pytest

from portbench import cells, gen, run

CELL = "bzip2-5.roundtrip-tiny"

#: a kind of data the harness does not have: low-entropy random bytes
KIND = '''
import numpy as np

TAG = 99


class Maker:
    def __init__(self, language_seed, params):
        self.symbols = int(params["symbols"])

    def object(self, rng, nbytes):
        return rng.integers(0, self.symbols, nbytes, dtype=np.uint8)
'''

#: an operation the harness does not have: compress, then decompress, both
#: by the port; the object must come back
OP = '''
import bz2

from portbench.workload import BaseOp


class Op(BaseOp):
    op = "roundtrip"
    KW_KEY = "engine"

    def _program(self, k):
        stream = self._port.compress(self.pool[k], self.level, **self.kw)
        return self._port.decompress(stream, device=self.kw["device"])

    def _control(self, k):
        return bz2.decompress(bz2.compress(self.pool[k], self.level))[:-1]

    def expected(self, used):
        return {k: self.pool[k] for k in used}
'''

SIZES = [3000, 70_000, 150_000]


def _digests(root):
    """Each file of the copy, by its path: its content's digest."""
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def _write(root, rel, text):
    with open(os.path.join(root, rel), "w") as fh:
        fh.write(text)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(os.path.join(cells.ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    # the new files: a configuration, a kind, an operation, a traffic mix,
    # a metric reader
    _write(root, "portbench/configs/bzip2-5.json", json.dumps(
        {"name": "bzip2-5", "level": 5, "block_bytes": 500_000,
         "engine": {"host_workers": 0}, "assumed": {}}))
    _write(root, "portbench/kinds/fixture-bytes.py", KIND)
    _write(root, "portbench/ops/roundtrip.py", OP)
    _write(root, "portbench/traffic/roundtrip-tiny.json", json.dumps(
        {"op": "roundtrip", "clients": 2, "pool": 3, "object_bytes": SIZES,
         "data": {"kind": "fixture-bytes", "language_seed": 1,
                  "symbols": 4}}))
    _write(root, "portbench/metrics/calls_started.roundtrip.py",
           "def read(probe):\n    return probe.calls_started\n")

    # the new entries
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "bzip2-5", "source": "fixture",
                             "file": "portbench/configs/bzip2-5.json",
                             "reduced": [], "why": "fixture"})
    bench["workloads"].append({"name": CELL, "config": "bzip2-5",
                               "traffic": "roundtrip-tiny", "chips": 1,
                               "why": "fixture"})
    bench["end_to_end"].append({"name": "roundtrip_MBps", "unit": "MB/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [CELL]})
    bench["per_layer"].append({"name": "calls_started.roundtrip",
                               "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "roundtrip_MBps",
                               "workloads": [CELL]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root, before


def test_fixture_cell_is_found_without_edits(fixture_root):
    root, before = fixture_root
    cell = cells.load(CELL, root=root)
    assert cell.config["level"] == 5 and cell.root == root
    assert cell.traffic["op"] == "roundtrip"
    assert [m["name"] for m in cell.per_layer] == ["calls_started.roundtrip"]
    assert {m["name"] for m in cell.end_to_end} == {"roundtrip_MBps",
                                                    "setup_s"}
    assert cells.op_class("roundtrip", root).op == "roundtrip"
    pool = gen.make_pool(cell.traffic, 3, root=root)
    assert sorted(len(o) for o in pool) == SIZES
    assert set(pool[0]) <= {0, 1, 2, 3}
    after = _digests(root)
    assert {k: after[k] for k in before} == before   # nothing edited
    assert set(after) - set(before) == {
        "portbench/configs/bzip2-5.json",
        "portbench/kinds/fixture-bytes.py",
        "portbench/ops/roundtrip.py",
        "portbench/traffic/roundtrip-tiny.json",
        "portbench/metrics/calls_started.roundtrip.py"}


@pytest.mark.parametrize("traced", [False, True], ids=["e2e", "traced"])
def test_fixture_cell_runs(fixture_root, traced):
    """The fixture cell runs whole on the CPU: its new operation on its
    new kind of data, mixed sizes, its new metrics, judged exactly."""
    root, _ = fixture_root
    cell = cells.load(CELL, root=root)
    res = run.run_cell(cell, 2 ** 31 + 77, 0.5, traced,
                       extra={"device": "cpu"})
    assert res["correct"] is True and res["failed"] == 0
    want = {"calls_started.roundtrip"} if traced else {"roundtrip_MBps",
                                                       "setup_s"}
    assert set(res["metrics"]) == want
    ctl = run.run_cell(cell, 2 ** 31 + 78, 0.5, False,
                       extra={"device": "cpu"}, control=True)
    assert ctl["correct"] is False
