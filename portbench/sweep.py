"""The client-count sweep that fixes a traffic mix's ``clients``.

    python3 -m portbench.sweep --workload <name> --seed <n>
        [--clients 1,2,4,8,16] [--seconds 20] [--repeats 2]
        [--trace-seconds 5]

In one process, for each client count: the cell's pool made once (as many
objects as the largest count, at least the mix's ``pool``), a warm-up at
that count, ``--repeats`` windows of ``--seconds`` without tracing, then
one window of ``--trace-seconds`` under torch.profiler for the device's
idle share.  Every call of every window is held against the reference.
Prints one JSON line a count (its rates, p95s, idle share, correct) and
last a line naming the smallest count whose median rate is within the
run-to-run spread of the highest median's count, below it (``choose``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import cells, gen, run, trace


def spread(values: list) -> float:
    """Distance between the first and third quartiles, as a share of the
    median (``statistics.quantiles(n=4)``)."""
    if len(values) < 2:
        return 0.0
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def choose(rows: list) -> int:
    """The smallest count whose median rate is within the run-to-run
    spread of the count with the highest median, below that median."""
    top = max(rows, key=lambda r: r["median_MBps"])
    best, tol = top["median_MBps"], top["spread"]
    for r in sorted(rows, key=lambda r: r["clients"]):
        if r["median_MBps"] >= best * (1.0 - tol):
            return r["clients"]
    return rows[-1]["clients"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--clients", default="1,2,4,8,16")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--trace-seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run._cache_dirs()
    cell = cells.load(args.workload)
    run.card(cell.chips)
    counts = [int(c) for c in args.clients.split(",")]
    traffic = dict(cell.traffic, clients=max(counts))
    pool = gen.make_pool(traffic, args.seed)
    op = cells.op_class(traffic["op"])(cell.config, pool)
    rows = []
    for c in counts:
        op.warm(c)
        rates, p95s, ok = [], [], True
        for _ in range(args.repeats):
            win = run.closed_loop(op, c, len(pool), args.seconds)
            e = run.end_to_end(op, win, args.seconds)
            rates.append(e[f"{op.op}_MBps"])
            p95s.append(e.get(f"{op.op}_p95_ms"))
            ok = ok and run.passed(run.judge(op, win))
        probe = trace.Probe()
        win = run.closed_loop(op, c, len(pool), args.trace_seconds, probe)
        ok = ok and run.passed(run.judge(op, win))
        row = {"clients": c, "MBps": rates, "p95_ms": p95s,
               "median_MBps": statistics.median(rates),
               "spread": spread(rates),
               "idle_pct": 100.0 * (1.0 - probe.busy_s() / probe.window_s()),
               "correct": ok}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"workload": args.workload, "chosen_clients": choose(rows),
           "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.stdout.flush()
