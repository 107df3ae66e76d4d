"""The benchmark's files, found by name.

``BENCHMARK.json`` (the checkout root) lists the cells; a cell names its
configuration (``configs/<file>``, by the configuration's ``file`` entry),
its traffic mix (``traffic/<name>.json``) and, through the ``per_layer``
entries that list it, its per-layer metrics (``metrics/<name>.py``; a
metric ``q.part``, one quantity split over cells that report different
end-to-end metrics, reads with ``metrics/<q>.py``).  A
configuration names its decoder family: the program's side is
``families/<family>.py``, the plain reference ``reference/<family>.py``.
A traffic mix names its mode, run by ``modes/<mode>.py``.  Adding a cell,
a configuration, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports
    root: Path

    @property
    def family(self):
        return importlib.import_module(
            f"{HERE.name}.families.{self.config['family']}")

    @property
    def runner(self):
        return importlib.import_module(
            f"{HERE.name}.modes.{self.traffic['mode']}")

    def metric_module(self, name: str):
        """The reader of metric ``name``: ``metrics/<name>.py``, where a
        name ``q.part`` (a quantity split over cells) reads with
        ``metrics/<q>.py``."""
        return importlib.import_module(
            f"{HERE.name}.metrics.{name.split('.')[0]}")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cells(root: Path) -> dict:
    """{workload name: its ``BENCHMARK.json`` entry} of the checkout at
    ``root``."""
    return {w["name"]: w for w in load_json(root / "BENCHMARK.json")
            ["workloads"]}


def load_cell(root: Path, workload: str) -> Cell:
    """The :class:`Cell` ``workload`` of the checkout at ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                root=root)


def listing(root: Path) -> dict:
    """Every configuration, traffic mix and metric file the benchmark
    holds, by kind: what a later cell can name."""
    return {
        "configs": sorted(p.stem for p in (HERE / "configs").glob("*.json")),
        "traffic": sorted(p.stem for p in (HERE / "traffic").glob("*.json")),
        "metrics": sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                          if not p.stem.startswith("_")),
        "families": sorted(p.stem for p in (HERE / "families").glob("*.py")
                           if not p.stem.startswith("_")),
    }
