"""Build the port's native host runtime (``bz2tpu_host.cpp``) with g++.

Counterpart of ``bzip2_tpu/native/build.py`` with its plain flags and
without its profile-guided flow, which trains through the JAX package's
api.  The shared object goes into ``build/bzip2_tpu_torch/host/`` beside
the package, keyed by a hash of the source and the flags, so an edited
source always rebuilds.  It is built at first use (``native.available()``
or any bound call), never at import; concurrent builds (test workers)
wait on one file lock and agree on one file.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "bz2tpu_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "bzip2_tpu_torch", "host")
FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbz2tpu_host_{h.hexdigest()[:16]}.so")


def ensure_built() -> str | None:
    """The keyed library's path, compiling it first if it is missing; None
    (with a note on stderr) if g++ is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):
                tmp = f"{so}.tmp{os.getpid()}"
                subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                               capture_output=True)
                os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError) as e:
        sys.stderr.write(f"bzip2_tpu_torch: native build failed ({e})\n")
        return None
