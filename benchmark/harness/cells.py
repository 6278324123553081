"""Finds a cell's parts by name: `BENCHMARK.json`'s cell, its configuration
file, its traffic file and the per-layer metrics that it reports.

Everything that belongs to one configuration, traffic mix or metric lives in
a file of its own under `benchmark/` (`configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py`), so a new cell is new files
and new entries, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "benchmark"


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, spec: dict | None = None, bench: Path = BENCH) -> SimpleNamespace:
    """The cell `name`: its entry, configuration, traffic and metric
    entries.  An unknown name raises KeyError, naming the known ones."""
    spec = load_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    config = _read(bench / "configs" / f"{cell['config']}.json")
    traffic = _read(bench / "traffic" / f"{cell['traffic']}.json")

    def applies(metric):
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in spec["end_to_end"] if applies(m)]
    per_layer = [m for m in spec["per_layer"] if applies(m)]
    return SimpleNamespace(name=name, cell=cell, config_entry=entry, config=config,
                           traffic=traffic, end_to_end=end_to_end, per_layer=per_layer)


def metric_reader(name: str):
    """`benchmark/metrics/<name>.py`'s `read(ctx)`."""
    return importlib.import_module(f"benchmark.metrics.{name}").read
