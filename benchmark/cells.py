"""Cells resolved by name from ``BENCHMARK.json``.

Everything of one configuration, one traffic mix or one metric sits in a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the entry's ``file``): the deployment: its
  scene, camera and renderer settings;
- ``traffic/<traffic>.json``: the client loop that drives it (``client``,
  a module of ``benchmark/clients``), the job's sizes, and what the
  comparison checks and its limits;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's
  value, or None where it finds nothing to read. One reader serves a
  quantity that cells split by name: without ``<metric>.py`` the name
  with its last ``.part`` dropped is tried, then the name after each
  ``_`` (``render_msamples_s.pool`` -> ``render_msamples_s.py``,
  ``mega_roofline`` -> ``roofline.py``).

A cell, a configuration, a traffic mix or a metric is added by adding
files and entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: pathlib.Path  # the checkout the files came from

    @property
    def settings(self) -> dict:
        """The renderer's settings: the configuration's, then the traffic's."""
        return {**self.config["render"], **self.traffic.get("render", {})}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout)."""
    root = HERE.parent if root is None else pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def reader_path(metric: str, root: pathlib.Path | None = None) -> pathlib.Path:
    """The file of ``metric``'s reader under ``root`` (see the module's
    docstring for the names tried)."""
    root = HERE.parent if root is None else pathlib.Path(root)
    names, base = [metric], metric
    while "." in base:
        base = base.rsplit(".", 1)[0]
        names.append(base)
    names += [base.split("_", k)[-1] for k in range(1, base.count("_") + 1)]
    for name in names:
        path = root / HERE.name / "metrics" / f"{name}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for the metric {metric!r} (tried {names})")


def reader(metric: str, root: pathlib.Path | None = None):
    """The ``read`` function of ``metric``'s reader under ``root``."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def client(cell: Cell):
    """The ``Client`` class of the cell's traffic (``benchmark/clients``)."""
    return importlib.import_module(f"benchmark.clients.{cell.traffic['client']}").Client
