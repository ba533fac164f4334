"""Stage laps of the host encoder's cyclic SA-IS on real corpus blocks
(counterpart of ``tools/sais_probe.py``).

    python -m bzip2_tpu_torch.tools.sais_probe [NBYTES] [--device cuda|cpu]

A child process encodes the first NBYTES (default 16 MiB) of the bench
corpus through ``bzip2_tpu_torch.api.compress(..., backend="native")``,
a warm pass and a timed one, first with the default sorter (bucket, MKQS
and copy, which turns to SA-IS only on deep repeats), then with the cyclic
SA-IS forced (``BZ2TPU_SAIS=1``).  With ``BZ2TPU_SAIS_TIMING=1`` the
port's native runtime prints a lap for each SA-IS stage of each top-level
call (``native/bz2tpu_host.cpp``, ``SaisLap``); the laps of the timed
SA-IS pass are summed by stage.  Both passes' rates are printed.  The
work runs on the host; ``--device`` is checked as for every tool of the
port, so a run without CUDA needs ``--device cpu``.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys

from ..bench import ROOT, log, resolve_device

CHILD = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
from bzip2_tpu_torch import api, hostmem
from bzip2_tpu_torch.bench import make_corpus
data = make_corpus(int(sys.argv[2]))
hostmem.warm_heap(512 * 1024 * 1024)

def timed(name):
    api.compress(data, 9, backend="native")     # warm pass (page faults)
    print(f"PHASE {name}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    api.compress(data, 9, backend="native")
    t1 = time.perf_counter()
    print(f"ENCODE {name}: {len(data) / 1e6 / (t1 - t0):.3f} MB/s "
          f"({t1 - t0:.3f} s for {len(data) / 1e6:.3f} MB)", file=sys.stderr,
          flush=True)

timed("default sorter")
os.environ["BZ2TPU_SAIS"] = "1"
timed("cyclic SA-IS")
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nbytes", nargs="?", type=int, default=16 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    env = dict(os.environ, BZ2TPU_SAIS_TIMING="1")
    p = subprocess.run([sys.executable, "-c", CHILD, ROOT, str(args.nbytes)],
                       env=env, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"sais child exited {p.returncode}:\n"
                           f"{p.stderr[-3000:]}")
    tot = collections.defaultdict(float)
    cnt = collections.defaultdict(int)
    phase = None
    for line in p.stderr.splitlines():
        if line.startswith("PHASE "):
            phase = line[6:]
        elif line.startswith("[sais]"):
            if phase == "cyclic SA-IS":
                _, stage, t, _n = line.split()
                tot[stage] += float(t)
                cnt[stage] += 1
        else:
            log(line, "sais")
    if not tot:
        raise RuntimeError("the native encoder printed no SA-IS lap")
    s = sum(tot.values())
    for k, v in sorted(tot.items(), key=lambda kv: -kv[1]):
        print(f"{k:10s} {v:8.4f} s  {100 * v / s:5.1f}%  calls={cnt[k]}",
              flush=True)
    print(f"{'TOTAL':10s} {s:8.4f} s (the timed SA-IS pass)", flush=True)
    return {"stages_s": dict(tot), "total_s": s}


if __name__ == "__main__":
    main()
