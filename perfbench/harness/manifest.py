"""BENCHMARK.json and the files it names: a cell's configuration, traffic
mix, driver, per-layer metric readers and limits are found by name."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_path(manifest: dict, config: str, root: str = ROOT) -> str:
    entry = next(c for c in manifest["configs"] if c["name"] == config)
    return os.path.join(root, entry["file"])


def traffic_path(traffic: str) -> str:
    return os.path.join(HERE, "traffic", f"{traffic}.json")


def driver_path(driver: str) -> str:
    return os.path.join(HERE, "drivers", f"{driver}.py")


def metric_path(metric: str) -> str:
    return os.path.join(HERE, "metrics", f"{metric}.py")


def limits_path(cell: str) -> str:
    return os.path.join(HERE, "limits", f"{cell}.json")


def end_to_end_of(manifest: dict, cell: str) -> List[dict]:
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(manifest: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


class Cell:
    """One workload of the manifest with everything it names, loaded."""

    def __init__(self, name: str, root: str = ROOT, manifest: dict | None = None):
        self.manifest = manifest if manifest is not None else load_manifest(root)
        matches = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = matches[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(config_path(self.manifest, self.entry["config"], root))
        self.traffic = load_json(traffic_path(self.entry["traffic"]))
        self.driver = load_module(driver_path(self.traffic["driver"]),
                                  f"perfbench_driver_{self.traffic['driver']}")
        self.end_to_end = end_to_end_of(self.manifest, name)
        self.per_layer = per_layer_of(self.manifest, name)
        lp = limits_path(name)
        self.limits: Dict[str, float] = load_json(lp)["limits"] if os.path.exists(lp) else {}

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(metric_path(m["name"]), "perfbench_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}
