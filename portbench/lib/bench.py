"""Find a cell's configuration, mix, parameters, metrics, traffic code and
reference by the names ``BENCHMARK.json`` and the mix give them, under one
root directory (the checkout: the folder that holds ``BENCHMARK.json`` and
``portbench/``)"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = "portbench"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    params: dict       # cells/<name>.json, {} where the cell has none


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[str, ModuleType] = {}

    def _path(self, *parts: str) -> pathlib.Path:
        return self.root.joinpath(HERE, *parts)

    def cell(self, name: str) -> Cell:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                path = self._path("cells", f"{name}.json")
                params = json.loads(path.read_text()) if path.exists() \
                    else {}
                return Cell(name=name, config=w["config"],
                            traffic=w["traffic"], chips=int(w["chips"]),
                            params=params)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return json.loads(self._path("mixes", f"{traffic}.json").read_text())

    def metrics(self, cell: Cell, end_to_end: bool) -> List[Metric]:
        """The metrics a cell reports: the end-to-end ones, or the
        per-layer ones, whose ``workloads`` name the cell (or that have no
        such key; a per-layer metric without it goes with every cell that
        reports the end-to-end metric it moves)."""
        e2e = {m["name"]: m for m in self.spec["end_to_end"]}

        def in_cell(m: dict) -> bool:
            if "workloads" in m:
                return cell.name in m["workloads"]
            if not end_to_end and m.get("moves") in e2e:
                return in_cell(e2e[m["moves"]])
            return True
        key = "end_to_end" if end_to_end else "per_layer"
        return [Metric(name=m["name"], unit=m["unit"])
                for m in self.spec[key] if in_cell(m)]

    def _load(self, *parts: str) -> ModuleType:
        path = self._path(*parts)
        key = str(path)
        mod = self._modules.get(key)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                "portbench_" + "_".join(p.replace(".", "_")
                                        for p in parts)[:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return mod

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``, or, where there is none, the reader of
        the name's part before its first dot (one reader for
        ``host_us_per_batch.saturated`` and ``.poisson``): its
        ``read(art)`` gives the value, or None where the run has nothing
        to read."""
        if not self._path("metrics", f"{metric}.py").exists():
            metric = metric.split(".", 1)[0]
        return self._load("metrics", f"{metric}.py")

    def arrivals(self, name: str) -> ModuleType:
        """``arrivals/<name>.py``: ``make(p, rng, *, widest, seconds)``
        gives a mix's ``lib/traffic.Stream``."""
        return self._load("arrivals", f"{name}.py")

    def loop(self, name: str) -> ModuleType:
        """``loops/<name>.py``: ``drive(system, stream, pool, seconds, p,
        profiler)`` runs a window and returns a ``lib/drive.Window``."""
        return self._load("loops", f"{name}.py")

    def reference(self, family: str) -> ModuleType:
        """``reference/<family>.py``: ``param_specs``, ``layers`` and
        ``forward`` of the plain PyTorch model."""
        return self._load("reference", f"{family}.py")
