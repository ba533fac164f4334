"""The port's native runtime under UBSan and ASan (counterpart of
``tools/sanitize.py``).

    python -m bzip2_tpu_torch.tools.sanitize [undefined|address ...]
        [--device cuda|cpu] [--scale 8] [--corrupt 25]

For each sanitizer (default both) ``native/bz2tpu_host.cpp`` is built with
it into ``build/bzip2_tpu_torch/sanitize/``, and a child process runs the
reference tool's sweep through the port's bindings: encode at -1 and -9
(``api.compress(..., backend="native")`` equal to ``bz2.compress``) and
decode (``native.decompress``) of ``--scale`` copies of golden sample 2,
round trips of adversarial inputs, and ``--corrupt`` streams with one bit
flipped, which must not crash.  The child points the binding's build hook
(``native.ensure_built``) at the sanitized library before its first call
and then checks that this library, and not the regular build, is the one
ctypes loaded and the process mapped: the reference once tested the wrong
binary by patching a loader after its binding had resolved.  The work runs
on the host; ``--device`` is checked as for every tool of the port.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..bench import ROOT, log, resolve_device

FLAGS = {"undefined": ["-fsanitize=undefined", "-fno-sanitize-recover=all"],
         "address": ["-fsanitize=address", "-fno-omit-frame-pointer"]}

SWEEP = r"""
import bz2, random, sys
root, so, regular, sample, scale, n_corrupt = sys.argv[1:7]
sys.path.insert(0, root)
from bzip2_tpu_torch import api, native
native.ensure_built = lambda: so
data = open(sample, "rb").read() * int(scale)
for lvl in (1, 9):
    c = api.compress(data, lvl, backend="native")
    if c != bz2.compress(data, lvl):
        raise SystemExit(f"-{lvl}: stream differs from bz2.compress")
    out, _, rc = native.decompress(c)
    if rc != 0 or out != data:
        raise SystemExit(f"-{lvl}: native.decompress rc {rc}")
for d in [b"", b"x", (b"a" * 300 + b"b" * 4 + b"c") * 2000, b"ab" * 450000,
          b"abcab" * 180000, bytes(range(256)) * 3000]:
    c = api.compress(d, 9, backend="native")
    if api.decompress(c, backend="native") != d:
        raise SystemExit(f"round trip of {len(d)} adversarial bytes differs")
rng = random.Random(6)
base = bz2.compress(data[:1_000_000], 9)
for _ in range(int(n_corrupt)):
    buf = bytearray(base)
    buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
    native.decompress(bytes(buf))
maps = open("/proc/self/maps").read()
if native._lib._name != so or so not in maps or regular in maps:
    raise SystemExit(f"loaded {native._lib._name}, not the sanitized {so}")
print("sweep ok")
"""


def run(kind: str, scale: int = 8, corrupt: int = 25) -> bool:
    """Build the runtime with sanitizer ``kind`` and run the sweep in a
    child; True when the child exits 0."""
    from ..native import build

    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), "sanitize")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libbz2tpu_host_{kind}.so")
    subprocess.run(["g++", "-O1", "-g", "-march=native", "-shared", "-fPIC",
                    *FLAGS[kind], "-o", so, build.SRC], check=True)
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0")
    if kind == "address":
        env["LD_PRELOAD"] = subprocess.run(
            ["g++", "-print-file-name=libasan.so"], capture_output=True,
            text=True, check=True).stdout.strip()
    sample = os.path.join(ROOT, "tests", "golden", "sample2.ref")
    r = subprocess.run([sys.executable, "-c", SWEEP, ROOT, so,
                        build.library_path(), sample, str(scale),
                        str(corrupt)], env=env, timeout=1800)
    ok = r.returncode == 0
    log(f"[{kind}] {'CLEAN' if ok else f'FAILED (rc {r.returncode})'}",
        "sanitize")
    return ok


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kinds", nargs="*", default=list(FLAGS),
                    help="undefined, address (default both)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--corrupt", type=int, default=25)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    bad = [k for k in args.kinds if k not in FLAGS]
    if bad:
        raise SystemExit(f"unknown sanitizer {bad}; choose from {list(FLAGS)}")
    res = {k: run(k, args.scale, args.corrupt) for k in args.kinds}
    if not all(res.values()):
        raise SystemExit(f"sanitizer sweep failed: {res}")
    return res


if __name__ == "__main__":
    main()
