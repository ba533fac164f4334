"""The port's command line (python -m bzip2_tpu_torch.cli) and recover
(python -m bzip2_tpu_torch.recover): the CLI and recover cases of
tests/test_surface.py, each run through the port with --backend=native and
through python -m bzip2_tpu.cli (or .recover) on the same input, with the
exit codes, outputs and files compared.  Then the "gpu" path in process
with the engine and the device decoder on the CPU, and the default and
"gpu" paths without CUDA, which must fail and leave no output file."""
import bz2 as stdlib_bz2
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import cli as tcli
from bzip2_tpu_torch import decoder as dmod
from bzip2_tpu_torch import engine as teng

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = "bzip2_tpu", "bzip2_tpu_torch"


def _run(pkg, tool, args, stdin=b"", cwd=None, env=None, backend="native"):
    """One run of ``python -m pkg.tool args``; the port's CLI gets
    ``--backend=native`` unless ``backend`` is None or args name one."""
    full = dict(os.environ)
    full["PYTHONPATH"] = str(ROOT) + os.pathsep + full.get("PYTHONPATH", "")
    full.pop("BZIP2", None)
    full.pop("BZIP", None)
    full.update(env or {})
    if pkg == PORT and tool == "cli" and backend and not any(
            a.startswith("--backend") for a in args):
        args = [f"--backend={backend}"] + args
    p = subprocess.run([sys.executable, "-m", f"{pkg}.{tool}"] + args,
                       input=stdin, capture_output=True, cwd=cwd, env=full,
                       timeout=300)
    return p.returncode, p.stdout, p.stderr


def _both(args, **kw):
    """(reference, port) results of the same CLI call."""
    return _run(REF, "cli", args, **kw), _run(PORT, "cli", args, **kw)


def _dirs(tmp_path, files: dict) -> dict:
    """The same files in a directory for each implementation."""
    out = {}
    for pkg in (REF, PORT):
        d = tmp_path / pkg
        d.mkdir()
        for name, data in files.items():
            (d / name).write_bytes(data)
        out[pkg] = d
    return out


def _listing(d: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ------------------------------------------------------------------ CLI ----

def test_cli_filter_round_trip():
    data = b"cli filter data" * 100
    (rc, comp, _), (prc, pcomp, _) = _both(["-z", "-1", "-c", "-f"],
                                          stdin=data)
    assert rc == prc == 0
    assert pcomp == comp == stdlib_bz2.compress(data, 1)
    (rc, out, _), (prc, pout, _) = _both(["-d", "-c"], stdin=comp)
    assert rc == prc == 0 and out == pout == data


def test_cli_files(tmp_path):
    dirs = _dirs(tmp_path, {"doc.txt": b"file mode round trip" * 50})
    for pkg, d in dirs.items():
        rc, _, err = _run(pkg, "cli", ["-z", "-1", str(d / "doc.txt")])
        assert rc == 0, err
        assert _listing(d) == {"doc.txt.bz2": stdlib_bz2.compress(
            b"file mode round trip" * 50, 1)}
        rc, _, err = _run(pkg, "cli", ["-d", str(d / "doc.txt.bz2")])
        assert rc == 0, err
        assert _listing(d) == {"doc.txt": b"file mode round trip" * 50}


def test_cli_keep_and_force(tmp_path):
    dirs = _dirs(tmp_path, {"k.txt": b"keep me"})
    rcs = {}
    for pkg, d in dirs.items():
        p = str(d / "k.txt")
        runs = [_run(pkg, "cli", a) for a in (["-z", "-k", p], ["-z", "-k", p],
                                             ["-z", "-k", "-f", p])]
        rcs[pkg] = [r[0] for r in runs]
        assert b"already exists" in runs[1][2]
    assert rcs[PORT] == rcs[REF] == [0, 1, 0]
    assert _listing(dirs[PORT]) == _listing(dirs[REF])


def test_cli_test_mode_and_exit_codes(tmp_path):
    raw = bytearray(stdlib_bz2.compress(b"y" * 1000, 1))
    raw[15] ^= 4
    dirs = _dirs(tmp_path, {"ok.bz2": stdlib_bz2.compress(b"x" * 1000, 1),
                            "bad.bz2": bytes(raw), "n.txt": b"plain"})
    rcs = {}
    for pkg, d in dirs.items():
        rcs[pkg] = [_run(pkg, "cli", a)[0] for a in (
            ["-t", str(d / "ok.bz2")], ["-t", str(d / "bad.bz2")],
            ["-d", str(d / "n.txt")])]
    assert rcs[PORT] == rcs[REF] == [0, 2, 2]
    assert _listing(dirs[PORT]) == _listing(dirs[REF])


def test_cli_trailing_garbage(tmp_path):
    dirs = _dirs(tmp_path, {"g.bz2": stdlib_bz2.compress(b"payload", 1)
                            + b"\x00garbage"})
    res = {pkg: _run(pkg, "cli", ["-d", "-c", str(d / "g.bz2")])[:2]
           for pkg, d in dirs.items()}
    assert res[PORT] == res[REF] == (0, b"payload")


def test_cli_cat_through_force(tmp_path):
    dirs = _dirs(tmp_path, {"plain.bin": b"not compressed"})
    res = {pkg: _run(pkg, "cli", ["-d", "-c", "-f", str(d / "plain.bin")])[:2]
           for pkg, d in dirs.items()}
    assert res[PORT] == res[REF] == (0, b"not compressed")


def test_cli_env_flags():
    (rc, out, _), (prc, pout, _) = _both(["-z", "-c", "-f"],
                                          stdin=b"env flag data" * 200,
                                          env={"BZIP2": "-1"})
    assert rc == prc == 0
    assert pout == out and pout[:4] == b"BZh1"  # level from env


def test_cli_version_and_bad_flag():
    (rc, _, err), (prc, _, perr) = _both(["-V"])
    assert rc == prc == 0 and b"version" in err and b"version" in perr
    assert b"PyTorch/CUDA" in perr
    (rc, _, err), (prc, _, perr) = _both(["-Q"])
    assert rc == prc == 1 and perr == err


def test_cli_bogus_backend_exits_3_without_output(tmp_path):
    """An unknown backend fails with exit 3 (the reference's, on encode)
    and leaves no output file, on encode and on decode."""
    data = b"bogus backend " * 300
    dirs = _dirs(tmp_path, {"in.txt": data,
                            "in2.txt.bz2": stdlib_bz2.compress(data, 1)})
    ref = _run(REF, "cli", ["--backend=bogus", "-z", str(dirs[REF] / "in.txt")])
    got = _run(PORT, "cli", ["--backend=bogus", "-z",
                             str(dirs[PORT] / "in.txt")])
    assert got[0] == ref[0] == 3 and b"bogus" in got[2]
    got = _run(PORT, "cli", ["--backend=bogus", "-d",
                             str(dirs[PORT] / "in2.txt.bz2")])
    assert got[0] == 3 and b"bogus" in got[2]
    assert _listing(dirs[PORT]) == _listing(dirs[REF]) == {
        "in.txt": data, "in2.txt.bz2": stdlib_bz2.compress(data, 1)}


@pytest.mark.parametrize("args", [["-z"], ["--backend=gpu", "-z"],
                                  ["-d"]])
def test_cli_card_paths_without_cuda_fail(tmp_path, args):
    """The default and "gpu" paths need the card: without CUDA the run
    exits non-zero with the CUDA error and makes no output file; nothing
    falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = b"needs the card " * 500
    (tmp_path / "in.txt").write_bytes(data)
    (tmp_path / "in2.txt.bz2").write_bytes(stdlib_bz2.compress(data, 1))
    name = "in2.txt.bz2" if "-d" in args else "in.txt"
    rc, out, err = _run(PORT, "cli", args + [str(tmp_path / name)],
                        backend=None)
    assert rc != 0 and b"CUDA" in err and out == b""
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.txt",
                                                          "in2.txt.bz2"]


def test_cli_main_gpu_path_on_cpu(tmp_path, monkeypatch):
    """cli.main with no backend, in process: encode through the registry's
    "gpu" entry (here an engine on the CPU, registered first, so the CLI
    registers none of its own) and decode through the device decoder (on
    the CPU), every block on the device path."""
    eng = teng.Engine(batch_size=2, host_workers=0, device="cpu")
    monkeypatch.setitem(tapi._BLOCK_ENCODERS, "gpu",
                        tapi._corrected(eng.encode_payloads))
    monkeypatch.setattr(tapi, "_default_backend", "gpu")
    monkeypatch.setattr(dmod, "_default", dmod.DeviceDecoder(device="cpu"))
    data = np.random.default_rng(0xC11).integers(
        0, 256, 150_000, dtype=np.uint8).tobytes()
    p = tmp_path / "in.bin"
    p.write_bytes(data)
    teng.reset_telemetry()
    assert tcli.main(["-zkf", "-1", str(p)]) == 0
    assert (tmp_path / "in.bin.bz2").read_bytes() == stdlib_bz2.compress(
        data, 1)
    assert teng.SHARE == {"blocks": 2, "dev_blocks": 2, "host_blocks": 0,
                          "declines": 0}
    p.unlink()
    dmod.reset_telemetry()
    assert tcli.main(["-d", str(tmp_path / "in.bin.bz2")]) == 0
    assert p.read_bytes() == data and not (tmp_path / "in.bin.bz2").exists()
    assert dmod.SHARE == {"blocks": 2, "dev_blocks": 2}
    assert tcli.main(["-t", "-q", str(tmp_path / "in.bin")]) == 2


# -------------------------------------------------------------- recover ----

def _recover_both(tmp_path, comp: bytes, name: str):
    dirs = _dirs(tmp_path, {name: comp})
    rcs = {pkg: _run(pkg, "recover", [str(d / name)])[0]
           for pkg, d in dirs.items()}
    assert rcs[PORT] == rcs[REF]
    assert _listing(dirs[PORT]) == _listing(dirs[REF])
    return rcs[PORT], dirs[PORT]


def test_recover_multiblock(tmp_path):
    data = np.random.default_rng(0xEC).integers(0, 256, 250_000,
                                                 dtype=np.uint8).tobytes()
    rc, d = _recover_both(tmp_path, stdlib_bz2.compress(data, 1), "dmg.bz2")
    assert rc == 0
    pieces = [stdlib_bz2.decompress((d / f"rec{i:05d}dmg.bz2").read_bytes())
              for i in range(1, 4)]
    assert b"".join(pieces) == data
    assert not (d / "rec00004dmg.bz2").exists()


def test_recover_with_corrupt_middle_block(tmp_path):
    data = np.random.default_rng(0xED).integers(0, 256, 250_000,
                                                 dtype=np.uint8).tobytes()
    comp = bytearray(stdlib_bz2.compress(data, 1))
    # corrupt a byte in the middle block's payload region
    comp[len(comp) // 2] ^= 0xFF
    rc, d = _recover_both(tmp_path, bytes(comp), "mid.bz2")
    assert rc == 0
    out = stdlib_bz2.decompress((d / "rec00001mid.bz2").read_bytes())
    assert data.startswith(out) and len(out) > 0
    assert len(list(d.glob("rec*mid.bz2"))) == 2


def test_recover_nothing_and_usage(tmp_path):
    rc, d = _recover_both(tmp_path, b"no blocks in here" * 10, "none.bz2")
    assert rc == 2
    assert _run(PORT, "recover", [])[0] == _run(REF, "recover", [])[0] == 1
    shutil.rmtree(tmp_path / REF)
