"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's object pool from the seed (``gen.py``), warms the
cell's shapes, then ``clients`` threads call the port in a closed loop for
``--seconds`` seconds: each client calls again as soon as its last call
returns, on the next object of the pool.  Once the window has closed every
call is waited for (a minute past the close at most) and every call's
output is held against the plain reference (``reference.py``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, ``host`` (a fixed host-CPU probe timed after the window,
so a drift of the host's speed between runs can be told from the
program's), and last ``checks``, each number compared beside its limit,
which also close standard error.

The run needs a CUDA card (as many as the cell names) and exits non-zero
with no result without one, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc), 0 elsewhere."""
    try:
        import os
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's start on the perf_counter clock
_T0 = _T_IMPORT - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from . import cells, gen, trace  # noqa: E402
from .reference import first_difference, host_probe  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "bzip2_tpu")
#: a call still running this long after the window's close is unanswered
ANSWER_WAIT_S = 60.0


def log(msg: str) -> None:
    sys.stderr.write(f"portbench: {msg}\n")
    sys.stderr.flush()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    base = os.path.join(cells.ROOT, "build", "portbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def card(chips: int) -> dict:
    """The card's name and count; raises SystemExit without CUDA or with
    fewer cards than the cell asks for.  Logs the power limit."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA card (torch.cuda.is_available() "
                         "is false); the benchmark does not run on the CPU")
    n = torch.cuda.device_count()
    if n < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{n} found")
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        power = smi.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        power = "not read"
    log(f"card: {name} x {n}; nvidia-smi name, power limit: {power}")
    return {"platform": "gpu", "kind": name, "count": chips}


def closed_loop(op, clients: int, pool_n: int, seconds: float,
                probe=None) -> dict:
    """``clients`` threads call ``op`` for ``seconds``; returns the calls
    (client, object, start, end, output, error), the window's bounds and
    the clients still running a minute past its close."""
    recs: list = []
    lock = threading.Lock()
    st: dict = {}

    def start():
        st["t0"] = time.perf_counter()
        st["ns0"] = time.time_ns()
        st["t_end"] = st["t0"] + seconds

    barrier = threading.Barrier(clients + 1, action=start)

    def client(i: int):
        barrier.wait()
        t_end = st["t_end"]
        j = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                return
            k = (i + j) % pool_n
            j += 1
            out = err = None
            try:
                out = op.call(k)
            except Exception as e:  # noqa: BLE001 -- counted as failed
                err = f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            with lock:
                recs.append((i, k, t0, t1, out, err))

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"client-{i}") for i in range(clients)]
    for t in threads:
        t.start()

    def window():
        barrier.wait()
        time.sleep(max(0.0, st["t_end"] - time.perf_counter()))

    if probe is None:
        window()
    else:
        import torch
        with trace.Session(probe):
            with torch.profiler.record_function("pb.window"):
                window()
            deadline = st["t_end"] + ANSWER_WAIT_S
            for t in threads:
                t.join(max(0.0, deadline - time.perf_counter()))
        if probe.window_ns == (0, 0):
            probe.window_ns = (st["ns0"], st["ns0"] + int(seconds * 1e9))
    deadline = st["t_end"] + ANSWER_WAIT_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    with lock:
        calls = list(recs)
    return {"calls": calls, "t0": st["t0"], "t_end": st["t_end"],
            "unanswered": sum(t.is_alive() for t in threads)}


def end_to_end(op, win: dict, seconds: float) -> dict:
    """The window's rates and tails, by the op's name."""
    calls = win["calls"]
    done = [c for c in calls if c[5] is None and c[3] <= win["t_end"]]
    lat = [c[3] - c[2] for c in calls if c[5] is None]
    nbytes = sum(op.raw_bytes(c[1]) for c in done)
    out = {f"{op.op}_MBps": nbytes / 1e6 / seconds,
           "setup_s": win["t0"] - _T0}
    if lat:
        out[f"{op.op}_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        out[f"{op.op}_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    log(f"{op.op} calls: {len(calls)} started in the window, {len(done)} "
        f"completed in it ({nbytes} bytes), {len(lat)} latencies in the "
        f"tail")
    return out


def judge(op, win: dict) -> dict:
    """Every call's output against the reference: the numbers compared,
    each with its limit."""
    t0 = time.perf_counter()
    calls = win["calls"]
    answered = [c for c in calls if c[5] is None]
    used = sorted({c[1] for c in answered})
    ref = op.expected(used)
    wrong = 0
    for c in answered:
        if c[4] != ref[c[1]]:
            wrong += 1
            if wrong <= 3:
                log(f"wrong output: client {c[0]} object {c[1]}: "
                    f"{len(c[4])} bytes against the reference's "
                    f"{len(ref[c[1]])}, first difference at byte "
                    f"{first_difference(c[4], ref[c[1]])}")
    errors = [c for c in calls if c[5] is not None]
    for c in errors[:3]:
        log(f"failed call: client {c[0]} object {c[1]}: {c[5]}")
    log(f"reference check: {len(answered)} outputs against {len(used)} "
        f"reference objects in {time.perf_counter() - t0:.3f} s")
    return {"wrong_outputs": {"value": wrong, "limit": 0},
            "failed_calls": {"value": len(errors), "limit": 0},
            "unanswered_calls": {"value": win["unanswered"], "limit": 0},
            "calls_checked": {"value": len(answered), "limit": 1}}


def passed(checks: dict) -> bool:
    return all((v["value"] >= v["limit"]) if k == "calls_checked"
               else (v["value"] <= v["limit"]) for k, v in checks.items())


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, *,
             device: dict | None = None, extra: dict | None = None,
             control: bool = False) -> dict:
    """One run of ``cell``: set-up, window, check.  ``device`` is the
    card's record (``card``); ``extra`` adds arguments to the program's
    calls (a test passes ``{"device": "cpu"}``); ``control`` puts the
    reference's control in the program's place.  Returns the result line
    as a dict."""
    traffic = cell.traffic
    clients = int(traffic["clients"])
    pool = gen.make_pool(traffic, seed, root=cell.root)
    op = cells.op_class(traffic["op"], cell.root)(cell.config, pool, extra)
    if control:
        op.use_control()
    probe = readers = None
    if traced:
        probe = trace.Probe()
        _breakdown_spans(probe, op)
        readers = {m["name"]: cells.reader(m["name"], cell.root)
                   for m in cell.per_layer}
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(probe)
    op.warm(clients)
    for r in (readers or {}).values():
        if hasattr(r, "start"):
            r.start(probe)
    win = closed_loop(op, clients, len(pool), seconds, probe)
    dev = dict(device or {"platform": "cpu", "kind": "cpu", "count": 0})
    dev["memory_peak_bytes"] = _memory_peak(dev)
    e2e = end_to_end(op, win, seconds)
    metrics: dict = {}
    result: dict = {}
    host = {"probe_ms_per_MiB": host_probe()}
    log(f"host probe (bz2 -9 of a fixed 2 MiB, one thread): "
        f"{host['probe_ms_per_MiB']} ms/MiB")
    if traced:
        answered = [c for c in win["calls"] if c[5] is None]
        probe.mib_started = sum(op.raw_bytes(c[1])
                                for c in answered) / 2 ** 20
        probe.calls_started = len(answered)
        for m in cell.per_layer:
            v = readers[m["name"]].read(probe)
            if v is None:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = probe.busy_s()
        dev["window_s"] = probe.window_s()
        result["breakdown"] = trace.breakdown(probe)
        log(f"trace: {len(probe.device)} device events")
    else:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise SystemExit(f"portbench: the harness does not compute "
                                 f"end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    checks = judge(op, win)
    failed = (checks["failed_calls"]["value"]
              + checks["unanswered_calls"]["value"])
    head = {"correct": passed(checks), "attempted": len(win["calls"]),
            "failed": failed, "metrics": metrics, "device": dev}
    head.update(result)
    head["host"] = host
    head["checks"] = checks
    return head


def _breakdown_spans(probe, op) -> None:
    """The host spans the breakdown names idle gaps by: each call, the
    stream framing, the decoder's block parse and each device batch."""
    from bzip2_tpu_torch import api, decoder, engine, native

    probe.wrap(op, "call", "call")
    for owner, attr, name in ((api, "frame", "frame"),
                              (native, "parse_block", "parse"),
                              (engine.Engine, "encode_batch", "batch"),
                              (decoder.DeviceDecoder, "_decode_batch",
                               "batch")):
        probe.wrap(owner, attr, name)


def _memory_peak(dev: dict) -> int:
    if dev.get("platform") != "gpu":
        return 0
    import torch
    return int(max(torch.cuda.max_memory_allocated(i)
                   for i in range(dev["count"])))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(res: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for k, v in res["checks"].items():
        rule = ">=" if k == "calls_checked" else "<="
        log(f"check {k}: {v['value']} (limit {rule} {v['limit']})")
    log(f"correct: {res['correct']}")
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()


def main(argv=None, control: bool = False) -> int:
    args = parse(argv)
    _cache_dirs()
    cell = cells.load(args.workload)
    dev = card(cell.chips)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device=dev, control=control)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}; no result")
        return 3
    emit(res)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # a client still inside the port a minute past the close cannot be
    # joined; it is counted unanswered, and the process ends without it
    os._exit(code)
