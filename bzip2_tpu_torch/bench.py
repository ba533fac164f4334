"""Single-card compress + decompress benchmark of the port (counterpart of
the root ``bench.py``), run as ``python -m bzip2_tpu_torch.bench``.

    BENCH_BYTES=85000000 BENCH_LEVEL=9 BENCH_ROUNDS=3 \\
        python -m bzip2_tpu_torch.bench [--device cuda|cpu]
                                        [--backend gpu|native]

The corpus is ``make_corpus``: real text from a deterministic walk of the
Python sources installed on the machine, topped up by a de-periodized mix
of the golden samples when the walk runs short; the run prints its source,
file count and sha256.  After a warm-up (``hostmem.warm_heap``, then one
batch-sized compress and decompress, untimed), each timed round runs, back
to back:

- encode: ``bzip2_tpu_torch.compress(data, level)``, the default engine;
- decode: ``bzip2_tpu_torch.decompress``, the device decoder;
- ``native.decompress``, the host decoder, timed beside it.

Every round's stream must equal ``bz2.compress(data, level)`` and both
decodes must return the data; a failure raises and no result line is
printed.  The baseline is stock ``bz2`` (libbz2), single-threaded, timed
once on the same bytes in the same run.  ``--backend native`` asks for the
host engine (``api.compress(backend="native")``) and ``native.decompress``
alone; the card is not touched.

Reports go to stderr: each round's rates, the median beside the best, the
encode split and stage walls, the decoder's stage walls and heals, the
kernels' launches in the timed rounds, the peak device memory and the
card's name and power limit.  The last line of stdout is one JSON object:
``metric``, ``value`` (combined MB/s of the best encode and best decode),
``unit`` and ``vs_baseline`` (over stock bz2's combined MB/s); the metric
names the corpus source and its share of golden fallback, on which stock
bz2 is slower than on walked text.  Without
CUDA the run exits non-zero unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import bz2
import glob
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bzip2_tpu_torch", "bench_corpus.bin")
WALK = ("/usr/lib/python3*/**/*.py", "/opt/venv/**/*.py")
FALLBACK_SEED = 20260816


def log(msg: str, tag: str = "bench") -> None:
    sys.stderr.write(f"[{tag}] {msg}\n")
    sys.stderr.flush()


# Copied from bench.py:106-160 (make_corpus): the same walk and golden-mix
# fallback, byte for byte; its cache lives under build/ and it reports what
# it read into ``info``.
def make_corpus(size: int, cache: str | None = CACHE,
                info: dict | None = None) -> bytes:
    """``size`` bytes of real text: the Python sources that ``WALK`` finds,
    in sorted order without repeats, then, if they run short, copies of
    the golden samples 1-3 with about 1% of each copy's bytes turned into
    seeded letters.  A complete walk is cached at ``cache`` (None: no
    cache) with its file count and length beside it, and serves every
    request up to that length.  ``info`` receives ``source`` ("walk",
    "walk+fallback" or "cache"), ``files`` and ``walk_bytes``: the files
    and bytes read by the walk (for "cache", by the walk that wrote it)."""
    info = {} if info is None else info
    try:
        if cache and os.path.getsize(cache) >= size:
            with open(cache, "rb") as fh:
                data = fh.read(size)
            with open(cache + ".json") as fh:
                meta = json.load(fh)
            info.update(source="cache", files=meta["files"],
                        walk_bytes=meta["bytes"])
            return data
    except (OSError, ValueError, KeyError):
        pass
    seen = set()
    files = []
    for pat in WALK:
        for f in sorted(glob.glob(pat, recursive=True)):
            r = os.path.realpath(f)
            if r not in seen:
                seen.add(r)
                files.append(r)
    buf = bytearray()
    n_read = 0
    for f in files:
        try:
            with open(f, "rb") as fh:
                buf += fh.read()
        except OSError:
            continue
        n_read += 1
        if len(buf) >= size:
            info.update(source="walk", files=n_read, walk_bytes=size)
            if cache:
                _write_cache(cache, buf[:size], n_read)
            return bytes(buf[:size])

    info.update(source="walk+fallback", files=n_read, walk_bytes=len(buf))
    gold = os.path.join(ROOT, "tests", "golden")
    srcs = [open(os.path.join(gold, f"sample{i}.ref"), "rb").read()
            for i in (1, 2, 3)]
    rng = np.random.default_rng(FALLBACK_SEED)
    i = 0
    while len(buf) < size:
        s = np.frombuffer(srcs[i % 3], np.uint8).copy()
        pos = rng.integers(0, s.size, max(1, s.size // 100))
        add = rng.integers(0, 26, pos.size)
        s[pos] = (((s[pos].astype(np.int32) - 97) % 26 + add) % 26 + 97
                  ).astype(np.uint8)
        buf += s.tobytes()
        i += 1
    return bytes(buf[:size])


def _write_cache(cache: str, data, n_files: int) -> None:
    """The walk's bytes, file count and length, each file replaced whole,
    so that a reader in another process never sees a partial file."""
    tmp = f"{cache}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, cache)
        with open(tmp, "w") as fh:
            json.dump({"files": n_files, "bytes": len(data)}, fh)
        os.replace(tmp, cache + ".json")
    except OSError:
        pass


def fallback_share(data: bytes, info: dict) -> float:
    """The share of ``data`` that is the golden-mix fallback, not walked
    text (0 for a walk or its cache, which only a complete walk writes)."""
    return max(0, len(data) - info["walk_bytes"]) / max(1, len(data))


def describe_corpus(data: bytes, info: dict) -> str:
    return (f"corpus {len(data)} bytes, source {info['source']} "
            f"({info['files']} files, {info['walk_bytes']} bytes walked, "
            f"{fallback_share(data, info):.1%} golden fallback), "
            f"sha256 {hashlib.sha256(data).hexdigest()}")


def resolve_device(device: str):
    """``torch.device(device)``; exits non-zero (no result line) when a
    CUDA device is asked for and CUDA is not available."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: CUDA is not "
                         "available; pass --device cpu to run on the CPU")
    return dev


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"
    for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def peak_gib(dev) -> str:
    import torch

    if dev.type != "cuda":
        return "not measured (cpu)"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"


def first_diff(a: bytes, b: bytes) -> int:
    """The index of the first byte where ``a`` and ``b`` differ (the
    shorter length when one is a prefix of the other)."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8) != np.frombuffer(b[:n], np.uint8)
    return int(np.argmax(x)) if x.any() else n


def run(size: int = 85_000_000, level: int = 9, rounds: int = 3,
        device: str = "cuda", backend: str = "gpu") -> dict:
    """The benchmark; returns its figures and ``json``, the result line.
    Raises RuntimeError on any inexact stream or decode."""
    import torch

    import bzip2_tpu_torch as port
    from . import _build, api, decoder, engine, hostmem, native

    if backend not in ("gpu", "native"):
        raise ValueError(f"backend must be 'gpu' or 'native', not {backend!r}")
    dev = resolve_device(device)
    card = card_line(dev)
    log(f"card: {card}; torch {torch.__version__}; level -{level}; "
        f"{rounds} rounds; backend {backend}")
    t0 = time.perf_counter()
    info: dict = {}
    data = make_corpus(size, info=info)
    log(f"{describe_corpus(data, info)} ({time.perf_counter() - t0:.3f} s)")
    mb = len(data) / 1e6

    t0 = time.perf_counter()
    expect = bz2.compress(data, level)
    stock_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    if bz2.decompress(expect) != data:
        raise RuntimeError("bz2.decompress does not return the corpus")
    stock_dec = time.perf_counter() - t0
    stock = mb / (stock_enc + stock_dec)
    log(f"stock bz2 -{level}: encode {mb / stock_enc:.3f} MB/s "
        f"({stock_enc:.3f} s), decode {mb / stock_dec:.3f} MB/s "
        f"({stock_dec:.3f} s), combined {stock:.3f} MB/s")

    kw = {} if device == "cuda" else {"device": device}
    if backend == "gpu":
        def encode(d):
            return port.compress(d, level, **kw)

        def decode(c):
            return port.decompress(c, **kw)
    else:
        def encode(d):
            return api.compress(d, level, backend="native")
        decode = None

    t0 = time.perf_counter()
    hostmem.warm_heap(min(512 << 20, 4 * len(data) + (256 << 20)))
    wslice = data[:engine.Engine.AUTO_BATCH_BYTES]
    wcomp = encode(wslice)
    if (decode is not None and decode(wcomp) != wslice) or \
            native.decompress(wcomp)[0] != wslice:
        raise RuntimeError("warm-up round trip differs")
    log(f"warm-up {time.perf_counter() - t0:.3f} s")

    engine.reset_telemetry()
    decoder.reset_telemetry()
    _build.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for r in range(rounds):
        t0 = time.perf_counter()
        comp = encode(data)
        t_enc = time.perf_counter() - t0
        if comp != expect:
            raise RuntimeError(
                f"round {r}: stream differs from bz2.compress(data, {level}) "
                f"at byte {first_diff(comp, expect)} ({len(comp)} vs "
                f"{len(expect)} bytes)")
        t_dec = None
        if decode is not None:
            t0 = time.perf_counter()
            out = decode(comp)
            t_dec = time.perf_counter() - t0
            if out != data:
                raise RuntimeError(f"round {r}: card decode differs at byte "
                                   f"{first_diff(out, data)}")
        t0 = time.perf_counter()
        out, consumed, rc = native.decompress(comp)
        t_nat = time.perf_counter() - t0
        if rc != 0 or out != data or consumed != len(comp):
            raise RuntimeError(f"round {r}: native.decompress rc {rc}, "
                               f"consumed {consumed} of {len(comp)}")
        runs.append({"encode_s": t_enc, "decode_s": t_dec,
                     "native_decode_s": t_nat})
        dec_txt = "" if t_dec is None else \
            f"card decode {mb / t_dec:.3f} MB/s ({t_dec:.3f} s), "
        log(f"round {r}: encode {mb / t_enc:.3f} MB/s ({t_enc:.3f} s), "
            f"{dec_txt}native.decompress {mb / t_nat:.3f} MB/s "
            f"({t_nat:.3f} s)")

    def stats(key):
        v = [x[key] for x in runs]
        return {"best_s": min(v), "median_s": statistics.median(v),
                "runs_s": v}

    info["fallback_share"] = fallback_share(data, info)
    res = {"bytes": len(data), "level": level, "backend": backend,
           "device": str(dev), "card": card, "corpus": info,
           "sha256": hashlib.sha256(data).hexdigest(),
           "ratio": len(data) / len(expect), "rounds": runs,
           "stock": {"encode_s": stock_enc, "decode_s": stock_dec},
           "encode": stats("encode_s"),
           "native_decode": stats("native_decode_s"),
           "share": dict(engine.SHARE),
           "encode_walls": dict(engine.STAGE_WALL),
           "decode_walls": dict(decoder.STAGE_WALL),
           "anomalies": dict(decoder.ANOMALIES),
           "wide_lanes": decoder.WIDE["lane"],
           "launches": {k: v.launches for k, v in _build.KERNELS.items()},
           "peak": peak_gib(dev)}
    keys = [("encode", "encode")]
    if decode is not None:
        res["decode"] = stats("decode_s")
        keys.append(("card decode", "decode"))
    keys.append(("native.decompress", "native_decode"))
    for name, key in keys:
        s = res[key]
        log(f"{name}: median {mb / s['median_s']:.3f} MB/s, best "
            f"{mb / s['best_s']:.3f} MB/s (runs "
            f"{' '.join(f'{x:.3f}' for x in s['runs_s'])} s)")
    sh = res["share"]
    log(f"encode split over {rounds} rounds: {sh['dev_blocks']} device + "
        f"{sh['host_blocks']} host of {sh['blocks']} blocks, declines "
        f"{sh['declines']}")
    log("encode stage walls (s, summed): " + json.dumps(
        {k: round(v, 4) for k, v in res["encode_walls"].items()}))
    log("decoder stage walls (s, summed): " + json.dumps(
        {k: round(v, 4) for k, v in res["decode_walls"].items()})
        + f"; anomalies {res['anomalies']}; lanes run again at their own "
        f"RLE1 width {res['wide_lanes']}")
    log("kernel launches in the timed rounds: " + json.dumps(res["launches"]))
    log(f"peak device memory {res['peak']}; card {card}")

    dec_key = "decode" if decode is not None else "native_decode"
    best = mb / (res["encode"]["best_s"] + res[dec_key]["best_s"])
    median = mb / (res["encode"]["median_s"] + res[dec_key]["median_s"])
    res["combined"] = {"best": best, "median": median, "stock": stock}
    log(f"combined: best {best:.3f} MB/s, median {median:.3f} MB/s, stock "
        f"bz2 {stock:.3f} MB/s")
    where = (f"{card}; encode bzip2_tpu_torch.compress, decode "
             f"bzip2_tpu_torch.decompress on {dev}" if backend == "gpu" else
             f"host-only: native engine, decode native.decompress; {card}")
    res["json"] = {
        "metric": f"single-card compress+decompress MB/s at -{level} "
                  f"(bit-exact=True; {where}; corpus {info['source']}, "
                  f"{info['fallback_share']:.1%} golden fallback; best of "
                  f"{rounds} rounds)",
        "value": round(best, 3),
        "unit": "MB/s",
        "vs_baseline": round(best / stock, 3),
    }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gpu", choices=("gpu", "native"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    res = run(size=int(os.environ.get("BENCH_BYTES", "85000000")),
              level=int(os.environ.get("BENCH_LEVEL", "9")),
              rounds=int(os.environ.get("BENCH_ROUNDS", "3")),
              device=args.device, backend=args.backend)
    print(json.dumps(res["json"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
