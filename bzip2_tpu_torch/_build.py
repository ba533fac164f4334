"""Build and bind the hand-written CUDA kernels under ``csrc/``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ctypes loads.  The library
goes into ``build/bzip2_tpu_torch/`` beside the package and is keyed by a
hash of the sources and flags, so an edited kernel always rebuilds.  A build
failure raises: there is no fallback for a CUDA tensor.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0 and
counts the successful launches (``launches``), so a run can show that its
main path went through each kernel.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bzip2_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()
#: guards the launch counters: the engine's device workers launch from
#: several threads
_count_lock = threading.Lock()


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbz2t_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the keyed library is missing; return its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = {s: f"{tmp}.{os.path.basename(s)}.o" for s in _sources()
            if s.endswith(".cu")}

    def check(cmd, rc, out, err):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{out}\n{err}")

    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in objs.items()]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        done = [(c, *p.communicate(), p.returncode) for c, p in zip(cmds, procs)]
        for c, out, err, rc in done:
            check(c, rc, out, err)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs.values()]
        r = subprocess.run(link, capture_output=True, text=True)
        check(link, r.returncode, r.stdout, r.stderr)
    finally:
        for o in objs.values():
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)     # atomic: concurrent builders agree on one file
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(build())
            lib.bz2t_error_string.restype = ct.c_char_p
            lib.bz2t_error_string.argtypes = [ct.c_int]
            _lib = lib
        return _lib


#: every kernel of the package by name (chip_smoke.py resets and reads them)
KERNELS: dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = _load()
            fn = getattr(lib, self.symbol)
            fn.restype = ct.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = _load().bz2t_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} ({rc})")
        with _count_lock:
            self.launches += 1


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def ptr(t) -> ct.c_void_p:
    """A tensor's device address; NULL for None."""
    return ct.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ct.c_void_p:
    import torch
    return ct.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(t, name: str, dtype, ndim: int) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
