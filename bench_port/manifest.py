"""Finds what ``BENCHMARK.json`` names: each configuration's file, each
traffic mix's file (``bench_port/traffic/<name>.json``) and each per-layer
metric's reader (``bench_port/metrics/<name>.py``), by name alone, so that a
later change adds a cell, a mix or a metric by adding files and entries."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _named(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


def workload(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config_path(man: dict, name: str) -> Path:
    return ROOT / _named(man["configs"], name, "configuration")["file"]


def config(man: dict, name: str) -> dict:
    return json.loads(config_path(man, name).read_text())


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_metric(name: str) -> ModuleType:
    """The reader module of a per-layer metric; it defines ``read(obs)``."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + name.replace(".", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
