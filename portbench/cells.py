"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own, and so does each per-layer metric's
reader.  Nothing here lists cells, configurations, traffic mixes or
metrics: adding one means adding its files and its entries.

* configuration ``c``: the ``file`` of the ``configs`` entry named ``c``
  (``portbench/configs/<c>.json``);
* traffic ``t``: ``portbench/traffic/<t>.json``, a data file read by
  ``gen.py``; it names an operation and a kind of data, each again a file
  of its own:

  - operation ``o``: ``portbench/ops/<o>.py``, a module with a class
    ``Op`` (the base and its contract: ``workload.BaseOp``);
  - kind of data ``k``: ``portbench/kinds/<k>.py``, a module with a
    ``TAG`` (a whole number no other kind uses: it keys the objects'
    random streams) and a class ``Maker(language_seed, params)`` whose
    ``object(rng, nbytes)`` returns ``nbytes`` uint8;

* per-layer metric ``m``: ``portbench/metrics/<m>.py``, a module with
  ``read(probe) -> float | None`` and, if it needs wrappers or counters,
  ``install(probe)``, called before the warm-up of a traced run, and
  ``start(probe)``, called after it.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    root: str = ROOT
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic mix and metric entries.  Raises KeyError for a
    name the file does not list, OSError for a missing file."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic",
                                      w["traffic"] + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, root=root,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def _module(root: str, folder: str, name: str, what: str):
    """``portbench/<folder>/<name>.py`` under ``root``, loaded by its path
    (names hold dots and dashes).  Raises ValueError where there is no
    such file."""
    path = os.path.join(root, "portbench", folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no {what} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The reader module of per-layer metric ``metric``
    (``portbench/metrics/<metric>.py``)."""
    return _module(root, "metrics", metric, "reader for metric")


def op_class(op: str, root: str = ROOT):
    """The class ``Op`` of operation ``op`` (``portbench/ops/<op>.py``)."""
    return _module(root, "ops", op, "operation").Op


def kind(name: str, root: str = ROOT):
    """The module of data kind ``name`` (``portbench/kinds/<name>.py``)."""
    return _module(root, "kinds", name, "data kind")
