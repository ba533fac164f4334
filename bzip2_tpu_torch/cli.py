# Copied from bzip2_tpu/cli.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Command-line program: ``bz2t`` with bzip2/bunzip2/bzcat personalities.

Mirrors the reference CLI (bzip2.c): argv[0] personalities
(bzip2.c:1856-1866), the full short/long flag surface (:1869-1934), env-var
flags BZIP2/BZIP (:1824-1829), suffix mapping .bz2/.bz/.tbz2/.tbz
(:1102-1128), exit protocol 0 ok / 1 env-io / 2 corrupt / 3 panic
(:651-654), -f overwrite + hard-link refusal (:959-1006), metadata
preservation (:1032-1078), tty guards (:1230-1257), trailing-garbage
tolerance after the first stream (:531-542), -f cat-through of non-bzip2
files (:504-515), interrupted-run cleanup (:687-741), and -t test mode.

Run it as ``python -m bzip2_tpu_torch.cli``.  ``--backend=gpu``, the
default, encodes through the port's engine on the card (the registry's
"gpu" entry, ``engine.default_engine()`` unless one was registered) and
decodes on the card (``bzip2_tpu_torch.decompress``); ``--backend=native``
encodes on the host alone (``engine_for(use_device=False)``) and decodes
on the host (the block/member-parallel decoder for regular files of 1 MB
and more, else the streaming one).  Any other backend exits 3, with no
output file left.
"""
from __future__ import annotations

import os
import shlex
import signal
import stat
import sys

from . import __version__ as _version
from . import api
from .stream import Compressor, Decompressor

PROG = "bz2t"

EXIT_OK, EXIT_ENV, EXIT_CORRUPT, EXIT_PANIC = 0, 1, 2, 3

_SUFFIXES = [(".bz2", ""), (".bz", ""), (".tbz2", ".tar"), (".tbz", ".tar")]


class _Opts:
    op = None          # "compress" | "decompress" | "test"
    stdout = False
    force = False
    keep = False
    small = False
    quiet = False
    verbosity = 0
    level = 9
    backend = None


def _err(msg: str) -> None:
    sys.stderr.write(f"{PROG}: {msg}\n")


def _parse_args(argv, prog_name):
    opts = _Opts()
    if "bunzip2" in prog_name or "bzcat" in prog_name or prog_name.endswith("-d"):
        opts.op = "decompress"
    if "bzcat" in prog_name:
        opts.stdout = True

    # env flags come first (bzip2.c:1824-1829)
    pre = []
    for var in ("BZIP2", "BZIP"):
        val = os.environ.get(var)
        if val:
            pre.extend(shlex.split(val))
    args = pre + list(argv)

    files = []
    seen_ddash = False
    long_map = {
        "--compress": ("op", "compress"), "--decompress": ("op", "decompress"),
        "--test": ("op", "test"), "--stdout": ("stdout", True),
        "--force": ("force", True), "--keep": ("keep", True),
        "--small": ("small", True), "--quiet": ("quiet", True),
        "--verbose": ("verbose", None), "--fast": ("level", 1),
        "--best": ("level", 9), "--version": ("version", None),
        "--license": ("version", None), "--exponential": (None, None),
        "--repetitive-fast": (None, None), "--repetitive-best": (None, None),
        "--help": ("help", None),
    }
    i = 0
    while i < len(args):
        a = args[i]
        i += 1
        if seen_ddash or not a.startswith("-") or a == "-":
            files.append(a)
            continue
        if a == "--":
            seen_ddash = True
            continue
        if a.startswith("--"):
            if a.startswith("--backend="):
                opts.backend = a.split("=", 1)[1]
                continue
            if a not in long_map:
                _err(f"bad flag: {a}")
                return None, None, EXIT_ENV
            key, val = long_map[a]
            if key is None:
                continue  # accepted, vestigial (workFactor knobs)
            if key == "verbose":
                opts.verbosity = min(4, opts.verbosity + 1)
            elif key == "version":
                sys.stderr.write(_banner())
                return None, None, EXIT_OK
            elif key == "help":
                sys.stderr.write(_usage())
                return None, None, EXIT_OK
            else:
                setattr(opts, key, val)
            continue
        for ch in a[1:]:
            if ch == "z":
                opts.op = "compress"
            elif ch == "d":
                opts.op = "decompress"
            elif ch == "t":
                opts.op = "test"
            elif ch == "c":
                opts.stdout = True
            elif ch == "f":
                opts.force = True
            elif ch == "k":
                opts.keep = True
            elif ch == "s":
                opts.small = True
            elif ch == "q":
                opts.quiet = True
            elif ch == "v":
                opts.verbosity = min(4, opts.verbosity + 1)
            elif ch in "123456789":
                opts.level = int(ch)
            elif ch in "LV":
                sys.stderr.write(_banner())
                return None, None, EXIT_OK
            elif ch == "h":
                sys.stderr.write(_usage())
                return None, None, EXIT_OK
            else:
                _err(f"bad flag: -{ch}")
                sys.stderr.write(_usage())
                return None, None, EXIT_ENV
    if opts.op is None:
        opts.op = "compress"
    if opts.small:
        # reference: -s caps the compress block size at 200k (bzip2.c:1937)
        opts.level = min(opts.level, 2)
    return opts, files, None


def _banner() -> str:
    return (f"{PROG}: bzip2 codec on PyTorch and CUDA, version {_version}.\n"
            "Format-compatible with bzip2/libbzip2; PyTorch/CUDA compute "
            "path.\n")


def _usage() -> str:
    return (f"usage: {PROG} [flags and input files in any order]\n"
            "   -h --help     this message          -d --decompress  force decompression\n"
            "   -z --compress force compression     -t --test        test integrity\n"
            "   -k --keep     keep input files      -f --force       overwrite outputs\n"
            "   -c --stdout   write to stdout       -q --quiet       suppress noise\n"
            "   -v --verbose  be verbose            -s --small       use less memory\n"
            "   -L --license  license & version     -V --version     same\n"
            "   -1 .. -9      block size 100k..900k --fast/--best    aliases for -1/-9\n"
            "If no file names are given, acts as a filter on stdin/stdout.\n")


def _out_name_decompress(name: str):
    for suf, repl in _SUFFIXES:
        if name.endswith(suf):
            return name[: -len(suf)] + repl, True
    return name + ".out", False


def _copy_metadata(src: str, dst: str) -> None:
    try:
        st = os.stat(src)
        os.utime(dst, (st.st_atime, st.st_mtime))
        os.chmod(dst, stat.S_IMODE(st.st_mode))
        if hasattr(os, "chown"):
            try:
                os.chown(dst, st.st_uid, st.st_gid)
            except PermissionError:
                pass
    except OSError:
        pass


def _open_output(path: str, force: bool):
    flags = os.O_WRONLY | os.O_CREAT | (0 if force else os.O_EXCL)
    if force:
        try:
            os.unlink(path)
        except OSError:
            pass
    fd = os.open(path, flags, 0o600)
    return os.fdopen(fd, "wb")


def _compress_stream(fin, fout, level, backend, small):
    comp = Compressor(level, backend=backend)
    n_in = n_out = 0
    while True:
        chunk = fin.read(1 << 20)
        if not chunk:
            break
        n_in += len(chunk)
        out = comp.compress(chunk)
        n_out += len(out)
        fout.write(out)
    out = comp.flush()
    n_out += len(out)
    fout.write(out)
    return n_in, n_out


def _decompress_stream(fin, fout, quiet, force, backend=None):
    """Multi-member decode with trailing-garbage tolerance; returns
    (ok, saw_magic)."""
    backend = backend or "gpu"
    if backend == "gpu":
        # the card: whole-buffer batched device decode
        data = fin.read()
        if not data:
            raise api.DataErrorMagic("empty input")
        from . import decompress as card_decompress
        out = card_decompress(data, multi_stream=True)
        if fout is not None:
            fout.write(out)
        return True, True
    if backend != "native":
        raise ValueError(f"unknown backend {backend!r}")
    # block/member-grain parallel decode for regular files (the host's -d
    # path on real inputs; stdin and small files stream)
    try:
        import stat as _stat
        st = os.fstat(fin.fileno())
        # upper bound: the parallel path holds the compressed file AND its
        # output in memory, so very large files (spewG-class) stay on the
        # constant-memory streaming decoder (BZ2TPU_PARALLEL_MAX bytes,
        # compressed, to override).
        par_max = int(os.environ.get("BZ2TPU_PARALLEL_MAX", 1 << 28))
        regular = (_stat.S_ISREG(st.st_mode)
                   and (1 << 20) <= st.st_size <= par_max)
    except (OSError, AttributeError, ValueError):
        regular = False
    if regular:
        from .parallel.decode import decompress_parallel
        data = fin.read()
        out = decompress_parallel(data)
        if fout is not None:
            fout.write(out)
        return True, True
    members = 0
    decomp = Decompressor()
    buffered = b""
    while True:
        chunk = buffered or fin.read(1 << 20)
        buffered = b""
        if not chunk:
            if not decomp.eof and members == 0:
                raise api.DataErrorMagic("empty input")
            if not decomp.eof and _decomp_in_progress(decomp):
                raise api.UnexpectedEOF("truncated stream")
            return True, members > 0
        try:
            out = decomp.decompress(chunk)
        except api.DataErrorMagic:
            if members == 0:
                raise
            if not quiet:
                _err("trailing garbage after compressed data ignored")
            return True, True
        if out and fout is not None:
            fout.write(out)
        if decomp.eof:
            members += 1
            tail = decomp.unused_data
            decomp = Decompressor()
            if tail:
                buffered = tail
            else:
                nxt = fin.read(1 << 20)
                if not nxt:
                    return True, True
                buffered = nxt


def _decomp_in_progress(decomp) -> bool:
    return decomp._bitpos > 0 or decomp._level != 0


def _is_tty(f) -> bool:
    try:
        return f.isatty()
    except Exception:
        return False


def _run_one(opts: _Opts, name: str | None) -> int:
    cleanup_path = None

    def handle(sig, frame):
        if cleanup_path and os.path.exists(cleanup_path):
            os.unlink(cleanup_path)
        sys.exit(EXIT_ENV)

    old = {}
    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            old[s] = signal.signal(s, handle)
        except ValueError:
            pass
    try:
        if opts.op == "compress":
            if name is None:
                if _is_tty(sys.stdout.buffer) and not opts.force:
                    _err("won't write compressed data to a terminal; use -f to force")
                    return EXIT_ENV
                _compress_stream(sys.stdin.buffer, sys.stdout.buffer,
                                 opts.level, opts.backend, opts.small)
                return EXIT_OK
            if name.endswith(".bz2") and not opts.force:
                _err(f"input file {name} already has .bz2 suffix")
                return EXIT_ENV
            st = os.stat(name)
            if not stat.S_ISREG(st.st_mode):
                _err(f"input {name} is not a normal file")
                return EXIT_ENV
            if st.st_nlink > 1 and not opts.force and not opts.keep:
                _err(f"input file {name} has {st.st_nlink - 1} other link(s)")
                return EXIT_ENV
            if opts.stdout:
                with open(name, "rb") as fin:
                    _compress_stream(fin, sys.stdout.buffer, opts.level,
                                     opts.backend, opts.small)
                return EXIT_OK
            out_name = name + ".bz2"
            try:
                fout = _open_output(out_name, opts.force)
            except FileExistsError:
                _err(f"output file {out_name} already exists")
                return EXIT_ENV
            cleanup_path = out_name
            with open(name, "rb") as fin, fout:
                n_in, n_out = _compress_stream(fin, fout, opts.level,
                                               opts.backend, opts.small)
            _copy_metadata(name, out_name)
            cleanup_path = None
            if opts.verbosity >= 1 and n_in:
                ratio = n_in / max(n_out, 1)
                _err(f"  {name}: {ratio:.3f}:1, {8*n_out/max(n_in,1):.3f} "
                     f"bits/byte, {100*(1-n_out/max(n_in,1)):.2f}% saved, "
                     f"{n_in} in, {n_out} out.")
            if not opts.keep:
                os.unlink(name)
            return EXIT_OK

        # decompress / test
        if name is None:
            if opts.op != "test" and _is_tty(sys.stdin.buffer) and not opts.force:
                _err("I won't read compressed data from a terminal")
                return EXIT_ENV
            sink = None if opts.op == "test" else sys.stdout.buffer
            _decompress_stream(sys.stdin.buffer, sink, opts.quiet, opts.force, opts.backend)
            return EXIT_OK
        st = os.stat(name)
        if st.st_nlink > 1 and not opts.force and not opts.keep and not opts.stdout:
            _err(f"input file {name} has {st.st_nlink - 1} other link(s)")
            return EXIT_ENV
        # cat-through of non-bzip2 files with -f (bzip2.c:504-515)
        with open(name, "rb") as probe:
            magic_ok = probe.read(3) == b"BZh"
        if not magic_ok and opts.op == "decompress":
            if opts.force and opts.stdout:
                with open(name, "rb") as fin:
                    while True:
                        b = fin.read(1 << 20)
                        if not b:
                            break
                        sys.stdout.buffer.write(b)
                return EXIT_OK
            _err(f"{name} is not a bzip2 file.")
            return EXIT_CORRUPT
        if opts.op == "test":
            with open(name, "rb") as fin:
                _decompress_stream(fin, None, opts.quiet, opts.force, opts.backend)
            if opts.verbosity >= 1:
                _err(f"  {name}: ok")
            return EXIT_OK
        if opts.stdout:
            with open(name, "rb") as fin:
                _decompress_stream(fin, sys.stdout.buffer, opts.quiet, opts.force, opts.backend)
            return EXIT_OK
        out_name, known = _out_name_decompress(name)
        if not known and not opts.quiet:
            _err(f"can't guess original name for {name} -- using {out_name}")
        try:
            fout = _open_output(out_name, opts.force)
        except FileExistsError:
            _err(f"output file {out_name} already exists")
            return EXIT_ENV
        cleanup_path = out_name
        with open(name, "rb") as fin, fout:
            _decompress_stream(fin, fout, opts.quiet, opts.force, opts.backend)
        _copy_metadata(name, out_name)
        cleanup_path = None
        if opts.verbosity >= 1:
            _err(f"  {name}: done")
        if not opts.keep:
            os.unlink(name)
        return EXIT_OK
    except FileNotFoundError as e:
        _err(f"{e.filename}: No such file or directory")
        return EXIT_ENV
    except PermissionError as e:
        _err(f"{e.filename}: Permission denied")
        return EXIT_ENV
    except api.DataErrorMagic:
        _err(f"{name or '(stdin)'}: bad magic number (file not created by bzip2)")
        return EXIT_CORRUPT
    except (api.DataError, api.UnexpectedEOF) as e:
        _err(f"{name or '(stdin)'}: {e}")
        if cleanup_path and os.path.exists(cleanup_path):
            os.unlink(cleanup_path)
        return EXIT_CORRUPT
    except BaseException:
        # any other failure: never leave a partial output file behind
        # (reference cleanUpAndFail, bzip2.c:687-741)
        if cleanup_path and os.path.exists(cleanup_path):
            os.unlink(cleanup_path)
        raise
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _enable_gpu(op: str) -> None:
    """Make the card's encoder or decoder before any output file exists, so
    that a machine without a usable card fails here.  The default engine is
    registered as "gpu" only when no "gpu" entry exists."""
    if op == "compress":
        if "gpu" not in api._BLOCK_ENCODERS:
            from .engine import default_engine, register_backend
            default_engine()
            register_backend()
    else:
        from .decoder import default_decoder
        default_decoder()


def main(argv=None, prog_name=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    prog_name = prog_name or os.path.basename(sys.argv[0] or PROG)
    opts, files, early = _parse_args(argv, prog_name)
    if early is not None or opts is None:
        return early if early is not None else EXIT_ENV
    if opts.verbosity:
        from . import tracing
        tracing.set_verbosity(opts.verbosity)
    if (opts.backend or "gpu") == "gpu":
        try:
            _enable_gpu(opts.op)
        except Exception as e:
            _err(f"cannot enable gpu backend: {e}")
            return EXIT_ENV
    try:
        if not files or files == ["-"]:
            return _run_one(opts, None)
        worst = EXIT_OK
        for f in files:
            if f == "-":
                rc = _run_one(opts, None)
            else:
                rc = _run_one(opts, f)
            worst = max(worst, rc)
        return worst
    except KeyboardInterrupt:
        return EXIT_ENV
    except Exception as e:  # internal error protocol (exit 3)
        _err(f"internal error: {e!r}")
        return EXIT_PANIC


if __name__ == "__main__":
    sys.exit(main())
