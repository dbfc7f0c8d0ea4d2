"""Everything the harness runs is found by the name ``BENCHMARK.json``
gives it, so that a configuration, a traffic mix, a driver or a metric
reader is added as a new file and no file that is there changes:

- configuration ``<name>``: ``configs/<name>.json``;
- traffic mix ``<name>``: ``traffic/<name>.json``, which names its
  driver;
- driver ``<name>``: ``drivers/<name>.py``;
- metric ``<name>``, end to end or per layer: ``metrics/<name>.py``,
  whose ``read(run)`` returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    """The parsed BENCHMARK.json at the root of the checkout."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, section: str, cell_name: str) -> list[dict]:
    """The metrics of a section ("end_to_end" or "per_layer") that a cell
    reports: those without a "workloads" key, and those that list it."""
    return [m for m in spec[section]
            if cell_name in m.get("workloads", [cell_name])]


def config(name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "configs", f"{_checked(name)}.json"))


def traffic(name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "traffic", f"{_checked(name)}.json"))


def _module(kind: str, name: str, bench: str):
    path = os.path.join(bench, kind, f"{_checked(name)}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    tag = re.sub(r"\W", "_", f"benchmark_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench: str = BENCH):
    return _module("drivers", name, bench)


def metric(name: str, bench: str = BENCH):
    return _module("metrics", name, bench)
