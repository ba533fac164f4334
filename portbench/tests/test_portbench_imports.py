"""Nothing the benchmark runs loads JAX or the JAX package, with top-level
module names compared whole (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "bzip2_tpu"}
PKG = os.path.join(cells.ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in glob.glob(os.path.join(PKG, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not set(_imports(p)) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_port():
    names = ["reference.py", "gen.py"] + [
        os.path.relpath(p, PKG)
        for p in glob.glob(os.path.join(PKG, "kinds", "*.py"))]
    assert len(names) >= 4
    for name in names:
        tops = set(_imports(os.path.join(PKG, name)))
        assert not tops & (FORBIDDEN | {"bzip2_tpu_torch", "torch"}), name


def test_loaded_modules_after_install():
    """Every module of the harness, every metric reader and its wrappers
    installed: no forbidden top-level name in sys.modules."""
    code = (
        "import sys, json\n"
        "from portbench import cells, run, sweep, control, trace, workload\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "probe = trace.Probe()\n"
        "for m in bench['per_layer']:\n"
        "    r = cells.reader(m['name'])\n"
        "    if hasattr(r, 'install'):\n"
        "        r.install(probe)\n"
        "for w in bench['workloads']:\n"
        "    c = cells.load(w['name'])\n"
        "    cells.op_class(c.traffic['op'])\n"
        "    cells.kind(c.traffic['data']['kind'])\n"
        "import bzip2_tpu_torch.engine, bzip2_tpu_torch.decoder\n"
        "print(' '.join(run.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1:] in ([], [""])


def test_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "bzip2_tpu_torchx", sys)
    assert "bzip2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bzip2_tpu.api", sys)
    assert "bzip2_tpu" in run.forbidden_modules()
