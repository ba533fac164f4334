"""Churn test of the port (counterpart of tests/test_churn.py): every file
of bzip2_tpu_torch/, docs/, tests/golden/, the top-level *.md and tools/
round-trips, the levels cycling through 1-9, each stream equal to
bz2.compress.  Imports no JAX, so on a machine with a card and no JAX it
runs with tests/test_torch_cuda.py:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py \\
        tests/test_torch_churn.py

The CPU test alternates the host backends "native" and "oracle" (the
NumPy and pure-Python reference codec, encode and decode); the card test encodes with "gpu" and
decodes with bzip2_tpu_torch.decompress on the card: many small blocks at
every level (short rows, few used byte values, padded groups)."""
import bz2
import glob
import os

import pytest
import torch

import bzip2_tpu_torch
from bzip2_tpu_torch import api
from bzip2_tpu_torch import decoder as dmod

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _files():
    out = []
    for pat in ("bzip2_tpu_torch/**/*.py", "bzip2_tpu_torch/**/*.cu",
                "bzip2_tpu_torch/**/*.cuh", "bzip2_tpu_torch/**/*.cpp",
                "docs/*", "tests/golden/*", "*.md", "tools/*"):
        out.extend(sorted(glob.glob(os.path.join(ROOT, pat), recursive=True)))
    return [f for f in out if os.path.isfile(f)]


def _read(f):
    with open(f, "rb") as fh:
        return fh.read()


def test_churn_roundtrip_host_backends():
    files = _files()
    assert len(files) > 60
    for i, f in enumerate(files):
        data = _read(f)
        level = 1 + i % 9
        backend = ("native", "oracle")[i % 2]
        comp = api.compress(data, level, backend=backend)
        assert comp == bz2.compress(data, level), (f, level, backend)
        assert api.decompress(comp, backend=backend) == data, (f, backend)


@pytest.mark.cuda
def test_churn_roundtrip_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = _files()
    dmod.reset_telemetry()
    for i, f in enumerate(files):
        data = _read(f)
        level = 1 + i % 9
        comp = api.compress(data, level, backend="gpu")
        assert comp == bz2.compress(data, level), (f, level)
        assert bzip2_tpu_torch.decompress(comp) == data, (f, level)
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert dmod.SHARE["dev_blocks"] == dmod.SHARE["blocks"] >= len(files) - 2
