"""The port's native host decoder (bzip2_tpu_torch/native/bz2tpu_host.cpp)
at every batch width of its chain chase.

The decoder chases up to DEC_K = 28 blocks' inverse-BWT chains in one
interleaved loop, with one template instance per chain count.  A batch of
19-27 blocks once ran the 28-chain instance and chased 9 chains whose
starts were never set, because a preprocessor test (``#if DEC_K >= 19``)
named an enum constant and read it as 0: a read through uninitialised
pointers that crashed the process only now and then.  The source is
compiled with ``-Werror=undef``, so no preprocessor test names an
identifier that is not a macro; and streams of 1 to 30 blocks are decoded
through the port's wrappers (``native.decode_some`` and
``native.decompress``) by a build with AddressSanitizer, in a child
process, which must report no invalid access.

The RLE1 split's wide path loads 35 bytes ahead of its position and stores
32 bytes (16 without AVX2) at the output's.  Its parity cases
(``torch_rle1_cases``) run through the AddressSanitizer build, each input
in a buffer of its own exact size, and through a build without AVX2 (the
16-byte path), in child processes: both give the reference's blocks, and
the sanitizer reports no invalid access.
"""
import bz2 as stdlib_bz2
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_rle1_cases
from bzip2_tpu import rle1 as jrle1
from bzip2_tpu_torch import rle1
from bzip2_tpu_torch.native import build

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 120

CHILD = r"""
import hashlib, json, sys
repo, so, path = sys.argv[1:4]
sys.path.insert(0, repo)
from bzip2_tpu_torch import native
native.ensure_built = lambda: so
stream = open(path, "rb").read()
some, nxt, level, _c, status, rc1 = native.decode_some(stream, 0, 0, 0)
whole, consumed, rc2 = native.decompress(stream)
print(json.dumps({
    "some": hashlib.sha256(some).hexdigest() if some is not None else None,
    "whole": hashlib.sha256(whole).hexdigest() if whole is not None else None,
    "status": status, "next_byte": (nxt + 7) // 8, "consumed": consumed,
    "rc": [rc1, rc2]}))
"""


def _gxx(*args, **kw):
    return subprocess.run(["g++", *args, str(build.SRC)], capture_output=True,
                          text=True, timeout=TIMEOUT, **kw)


def test_preprocessor_tests_name_only_macros():
    r = _gxx("-fsyntax-only", "-march=native", "-Werror=undef")
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope="module")
def asan_lib(tmp_path_factory):
    """The host runtime built with AddressSanitizer, and the sanitizer
    runtime a child must preload to load it."""
    so = tmp_path_factory.mktemp("asan") / "libbz2tpu_host_asan.so"
    # the pattern fill makes an uninitialised local a large value, so that
    # a pointer chased from one lands far outside the decoder's tables
    r = _gxx("-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer",
             "-ftrivial-auto-var-init=pattern", "-march=native", "-shared",
             "-fPIC", "-o", str(so))
    assert r.returncode == 0, r.stderr[-2000:]
    rt = subprocess.run(["g++", "-print-file-name=libasan.so"],
                        capture_output=True, text=True).stdout.strip()
    assert os.path.isabs(rt), "g++ has no AddressSanitizer runtime"
    return so, rt


@pytest.mark.parametrize("n_blocks", [1, 19, 27, 28, 30])
def test_decoders_under_asan_at_every_batch_width(asan_lib, tmp_path,
                                                  n_blocks):
    """A level-1 stream of ``n_blocks`` blocks: one batch of that many, or
    a full batch of 28 and a tail of 2.  Both decoders return the data,
    consume the whole stream and make no invalid access."""
    so, rt = asan_lib
    rng = np.random.default_rng(n_blocks)
    data = rng.integers(97, 105, n_blocks * 99_000 - 40_000,
                        dtype=np.uint8).tobytes()
    assert len(rle1.encode_blocks(data, 1)) == n_blocks
    comp = stdlib_bz2.compress(data, 1)
    path = tmp_path / "in.bz2"
    path.write_bytes(comp)
    env = {**os.environ, "LD_PRELOAD": rt,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=0"}
    r = subprocess.run([sys.executable, "-c", CHILD, str(REPO), str(so),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    sha = hashlib.sha256(data).hexdigest()
    assert res == {"some": sha, "whole": sha, "status": 1,
                   "next_byte": len(comp), "consumed": len(comp),
                   "rc": [0, 0]}


SPLIT_CHILD = r"""
import json, sys
repo, so = sys.argv[1:3]
sys.path[:0] = [repo, repo + "/tests"]
import numpy as np
import torch_rle1_cases as cases
from bzip2_tpu_torch import native, rle1
native.ensure_built = lambda: so
out = {}
for group, items in cases.groups().items():
    # a copy of its own exact size: a read past the input is past the
    # allocation
    out[group] = [cases.summary(rle1.encode_blocks(
        np.frombuffer(data, np.uint8).copy(), level, nmax))
        for data, level, nmax in items]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def no_avx2_lib(tmp_path_factory):
    """The host runtime built with the port's flags but without AVX2."""
    so = tmp_path_factory.mktemp("noavx2") / "libbz2tpu_host_noavx2.so"
    r = _gxx(*build.FLAGS, "-mno-avx2", "-o", str(so))
    assert r.returncode == 0, r.stderr[-2000:]
    return so, None


@pytest.mark.parametrize("which", ["asan", "no_avx2"])
def test_split_wide_path_in_child_builds(which, request):
    """The split's parity cases through the sanitizer build (AVX2 as
    -march=native gives it) and the build without AVX2 give the
    reference's blocks; the sanitizer reports nothing."""
    so, rt = request.getfixturevalue(f"{which}_lib")
    env = dict(os.environ)
    if rt is not None:
        env.update(LD_PRELOAD=rt,
                   ASAN_OPTIONS="detect_leaks=0:abort_on_error=0")
    r = subprocess.run([sys.executable, "-c", SPLIT_CHILD, str(REPO),
                        str(so)], capture_output=True, text=True, env=env,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "AddressSanitizer" not in r.stderr, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    groups = torch_rle1_cases.groups()
    assert sorted(got) == sorted(groups)
    for group, items in groups.items():
        exp = [torch_rle1_cases.summary(jrle1.encode_blocks(d, lv, nm))
               for d, lv, nm in items]
        assert got[group] == exp, group
