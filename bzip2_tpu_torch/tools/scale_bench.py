"""Scale benchmarks of the port (counterpart of ``tools/scale_bench.py``):
an enwik8-class 100 MiB encode and decode at -9, a spewG-class stream of
2.5 GiB written and read back through the file API, and the -1..-9
bit-exact matrix.

    python -m bzip2_tpu_torch.tools.scale_bench [--small] [--spew-gb G]
        [--levels] [--device cuda|cpu] [--backend gpu|native]
        [--host-workers K] [--path FILE]

``--small``: 10 MiB and a 64 MiB spew (``SMALL_BYTES``, ``SMALL_SPEW``).  ``--levels``: the matrix only, on
105 MiB (10 MiB with ``--small``).  ``--device`` registers an engine on
that device as the registry's "gpu" entry and a decoder on it;
``--host-workers 0`` makes that engine encode every block on the device
(by default one host worker steals blocks, and the file API's one-block
calls tend to go to it).  ``--backend native`` encodes and decodes on the
host.  The spew is generated, written, read back and hashed in 8 MiB
chunks; the file's reads decode on the host, as the file API's always do.
Printed: rates, bit-exactness, the engine's device/host split, the BWT's
doubling rounds, peak RSS, peak device memory and
``torch.cuda.memory_reserved()`` at the start and end of the spew.
"""
from __future__ import annotations

import argparse
import bz2
import hashlib
import os
import resource
import threading
import time

import numpy as np

from ..bench import (card_line, describe_corpus, first_diff, log,
                     make_corpus, peak_gib, resolve_device)


#: the corpus bytes (100 MiB-class run) and the spew bytes of --small
SMALL_BYTES = 10 << 20
SMALL_SPEW = 64 << 20


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _say(msg: str) -> None:
    log(msg, "scale")


# Copied from tools/scale_bench.py:57-74 (spew_chunks).
def spew_chunks(total: int, chunk: int = 8 << 20):
    """Deterministic highly-compressible pseudo-text, generated lazily."""
    line = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog %d\n" % 7) * 400,
        np.uint8)
    base = np.tile(line, chunk // line.size + 1)[:chunk].copy()
    done = 0
    i = 0
    while done < total:
        n = min(chunk, total - done)
        buf = base[:n].copy()
        # sprinkle variation so blocks aren't identical
        buf[::4093] = 97 + (i % 23)
        yield buf.tobytes()
        done += n
        i += 1


def setup(device: str = "cuda", backend: str = "gpu",
          host_workers: int | None = None, mode: str | None = None):
    """Register an engine on ``device`` (with ``host_workers`` and
    ``mode``) as the "gpu" entry and a decoder on it as the default
    decoder; returns the torch device.  ``backend="native"`` registers
    nothing."""
    from .. import api, decoder
    from ..engine import engine_for

    dev = resolve_device(device)
    if backend == "gpu":
        kw = {k: v for k, v in (("device", None if device == "cuda"
                                 else device),
                                ("host_workers", host_workers),
                                ("mode", mode)) if v is not None}
        api.register_block_encoder("gpu", engine_for(**kw).encode_payloads)
        decoder._default = decoder.DeviceDecoder(device=dev)
    elif backend != "native":
        raise ValueError(f"backend must be 'gpu' or 'native', not {backend!r}")
    return dev


class _Rounds:
    """Counts ``bwt_batched`` calls and their doubling rounds through
    ``ops.bwt.ROUND_HOOK``.  The hook is fed from the round record the
    device writes, read once at the end of each call: with the hook set,
    each ``bwt_batched`` call makes that one host sync."""

    def __init__(self):
        self.batches = 0
        self.full = 0
        self.tail = 0
        self._lock = threading.Lock()   # the device workers' threads call

    def __call__(self, stage, k, unres):
        with self._lock:
            if stage == 0 and k == 16:
                self.batches += 1
            elif stage == 0:
                self.full += 1
            else:
                self.tail += 1

    def __enter__(self):
        from ..ops import bwt
        bwt.ROUND_HOOK = self
        return self

    def __exit__(self, *exc):
        from ..ops import bwt
        bwt.ROUND_HOOK = None

    def text(self) -> str:
        b = max(self.batches, 1)
        return (f"BWT: {self.batches} batches, {self.full} full-width "
                f"doubling rounds ({self.full / b:.2f} a batch), {self.tail} "
                f"tail rounds ({self.tail / b:.2f} a batch)")


def _share() -> dict:
    from .. import engine
    return dict(engine.SHARE)


def _split(sh: dict) -> str:
    return (f"{sh['dev_blocks']} device + {sh['host_blocks']} host of "
            f"{sh['blocks']} blocks, declines {sh['declines']}")


def bench_100mb(size: int, backend: str, dev, level: int = 9) -> dict:
    """``api.compress`` and ``api.decompress`` of ``size`` corpus bytes at
    ``level`` on ``backend``; raises on a stream or decode that is not
    exact."""
    import torch

    from .. import api, decoder, engine

    info: dict = {}
    data = make_corpus(size, info=info)
    _say(describe_corpus(data, info))
    engine.reset_telemetry()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with _Rounds() as rounds:
        t0 = time.perf_counter()
        comp = api.compress(data, level, backend=backend)
        t_enc = time.perf_counter() - t0
    sh = _share()
    decoder.reset_telemetry()
    t0 = time.perf_counter()
    out = api.decompress(comp, backend=backend)
    t_dec = time.perf_counter() - t0
    if out != data:
        raise RuntimeError("100MB-class: decode differs from the corpus")
    exact = comp == bz2.compress(data, level)
    mb = len(data) / 1e6
    _say(f"[100MB-class] {mb:.3f} MB at -{level}: encode "
         f"{mb / t_enc:.3f} MB/s ({t_enc:.3f} s), decode {mb / t_dec:.3f} MB/s ({t_dec:.3f} s), "
         f"ratio {len(data) / len(comp):.3f}:1, bit-exact={exact}, split "
         f"{_split(sh)}, decoder heals {decoder.ANOMALIES['lane']}, peak "
         f"RSS {rss_mb():.0f} MB, peak device {peak_gib(dev)}")
    _say(f"[100MB-class] {rounds.text()}")
    if not exact:
        raise RuntimeError("100MB-class: stream differs from bz2.compress")
    return {"bytes": len(data), "encode_s": t_enc, "decode_s": t_dec,
            "share": sh, "heals": decoder.ANOMALIES["lane"],
            "rss_mb": rss_mb(), "peak": peak_gib(dev)}


def _reserved(dev) -> str:
    import torch

    if dev.type != "cuda":
        return "not measured (cpu)"
    return f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB"


def bench_spew(total: int, path: str, backend: str, dev,
               level: int = 9) -> dict:
    """Write ``total`` spew bytes through ``BZ2TFile`` at ``level`` on
    ``backend``, read them back and compare sha256; raises on a
    mismatch."""
    import torch

    from .. import engine
    from ..file import BZ2TFile

    engine.reset_telemetry()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reserved0 = _reserved(dev)
    h_in = hashlib.sha256()
    n_in = 0
    t0 = time.perf_counter()
    trail = []      # memory_reserved after each eighth of the stream
    with _Rounds() as rounds, BZ2TFile(path, "wb", compresslevel=level,
                                       backend=backend) as f:
        for ch in spew_chunks(total):
            h_in.update(ch)
            f.write(ch)
            n_in += len(ch)
            if n_in * 8 // total > len(trail):
                trail.append(_reserved(dev))
    t_enc = time.perf_counter() - t0
    sh = _share()
    csize = os.path.getsize(path)
    _say(f"[spewG-class] wrote {n_in / 1e9:.3f} GB -> {csize / 1e6:.3f} MB "
         f"({n_in / 1e6 / t_enc:.3f} MB/s, {t_enc:.3f} s), split "
         f"{_split(sh)}, peak RSS {rss_mb():.0f} MB, peak device "
         f"{peak_gib(dev)}, reserved {reserved0} at the start, "
         f"{_reserved(dev)} at the end")
    _say(f"[spewG-class] {rounds.text()}")
    _say(f"[spewG-class] reserved after each eighth: {', '.join(trail)}")
    h_out = hashlib.sha256()
    n_out = 0
    t0 = time.perf_counter()
    with BZ2TFile(path, "rb") as f:
        while True:
            ch = f.read(8 << 20)
            if not ch:
                break
            h_out.update(ch)
            n_out += len(ch)
    t_dec = time.perf_counter() - t0
    ok = n_out == n_in and h_in.digest() == h_out.digest()
    _say(f"[spewG-class] read back {n_out / 1e9:.3f} GB "
         f"({n_out / 1e6 / t_dec:.3f} MB/s, {t_dec:.3f} s), sha256 "
         f"match={ok} ({h_in.hexdigest()}), peak RSS {rss_mb():.0f} MB")
    os.unlink(path)
    if not ok:
        raise RuntimeError("spewG-class: read-back sha256 differs")
    return {"bytes": n_in, "compressed": csize, "encode_s": t_enc,
            "decode_s": t_dec, "share": sh, "rss_mb": rss_mb(),
            "peak": peak_gib(dev), "reserved": [reserved0, *trail],
            "bwt_batches": rounds.batches, "bwt_full_rounds": rounds.full,
            "sha256": h_in.hexdigest()}


def level_matrix(data: bytes, levels, backend: str, dev,
                 encode=None) -> list:
    """Each level's stream of ``data`` against ``bz2.compress`` and its
    decode against ``data``; raises at the first level that is not exact.
    ``encode(data, level)`` defaults to ``api.compress`` on ``backend``.
    Prints each level's batch shape, walls, the decoder's host heals, its
    lanes run again at their own RLE1 width, and peak device memory."""
    import torch

    from .. import api, decoder, engine

    if encode is None:
        def encode(d, level):
            return api.compress(d, level, backend=backend)
    mb = len(data) / 1e6
    out = []
    for level in levels:
        shapes = []
        real = engine.batch_arrays

        def spy(blocks, bsz, N):
            shapes.append((bsz, N))
            return real(blocks, bsz, N)

        engine.reset_telemetry()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        engine.batch_arrays = spy
        try:
            t0 = time.perf_counter()
            comp = encode(data, level)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_enc = time.perf_counter() - t0
        finally:
            engine.batch_arrays = real
        sh = _share()
        exp = bz2.compress(data, level)
        if comp != exp:
            raise RuntimeError(
                f"level-matrix -{level}: stream differs from bz2.compress at "
                f"byte {first_diff(comp, exp)} ({len(comp)} vs {len(exp)} "
                f"bytes; batches {shapes})")
        decoder.reset_telemetry()
        t0 = time.perf_counter()
        dec = api.decompress(comp, backend=backend)
        t_dec = time.perf_counter() - t0
        if dec != data:
            raise RuntimeError(f"level-matrix -{level}: decode differs")
        row = {"level": level, "encode_s": t_enc, "decode_s": t_dec,
               "ratio": len(data) / len(comp), "batches": shapes,
               "share": sh, "heals": decoder.ANOMALIES["lane"],
               "wide": decoder.WIDE["lane"], "peak": peak_gib(dev)}
        out.append(row)
        _say(f"[level-matrix] -{level}: encode {mb / t_enc:8.3f} MB/s "
             f"({t_enc:.3f} s), decode {mb / t_dec:8.3f} MB/s "
             f"({t_dec:.3f} s), ratio {row['ratio']:.3f}:1, bit-exact=True, "
             f"batches (rows x N) {shapes}, split {_split(sh)}, decoder "
             f"heals {row['heals']}, lanes run again at their own RLE1 "
             f"width {row['wide']}, peak device {row['peak']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--spew-gb", type=float, default=2.5)
    ap.add_argument("--levels", action="store_true",
                    help="run the -1..-9 bit-exact matrix only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gpu", choices=("gpu", "native"))
    ap.add_argument("--host-workers", type=int, default=None)
    ap.add_argument("--path", default=None,
                    help="the spew's file (default build/scale_spew.bz2)")
    args = ap.parse_args(argv)
    dev = setup(args.device, args.backend, args.host_workers)
    _say(f"card: {card_line(dev)}; backend {args.backend}; host workers "
         f"{args.host_workers}")
    res: dict = {}
    if args.levels:
        size = SMALL_BYTES if args.small else (105 << 20)
        info: dict = {}
        data = make_corpus(size, info=info)
        _say(describe_corpus(data, info))
        res["levels"] = level_matrix(data, range(1, 10), args.backend, dev)
        return res
    size = SMALL_BYTES if args.small else (100 << 20)
    spew = SMALL_SPEW if args.small else int(args.spew_gb * (1 << 30))
    from ..bench import ROOT
    path = args.path or os.path.join(ROOT, "build", "scale_spew.bz2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    res["100mb"] = bench_100mb(size, args.backend, dev)
    res["spew"] = bench_spew(spew, path, args.backend, dev)
    return res


if __name__ == "__main__":
    main()
