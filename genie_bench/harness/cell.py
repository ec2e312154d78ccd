"""A cell, found by its name: the `BENCHMARK.json` entry, its configuration,
its traffic mix, its metrics and the modules they name.  Adding a cell, a
configuration, a mix, a loop or a metric adds files and entries; nothing
here names one.  A mix's `k`, where it states one, is the `k` of the
configuration as the cell runs it."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

from genie_bench.harness import traffic

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict                      # the configuration file
    mix: dict                      # the traffic file
    end_to_end: list               # BENCHMARK.json entries reported with --trace 0
    per_layer: list                # ... with --trace 1

    def reference(self):
        return importlib.import_module(f"genie_bench.reference.{self.cfg['reference']}")

    def system(self):
        return importlib.import_module(f"genie_bench.systems.{self.cfg['system']}")

    def loop(self):
        return traffic.make_loop(self.mix)


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = traffic.check_mix(json.loads(
        (BENCH_DIR / "traffic" / f"{_named(w['traffic'])}.json").read_text()))
    if "k" in mix:
        cfg["k"] = mix["k"]
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
                per_layer=[m for m in bench["per_layer"] if _for(m, name)])


def metric_reader(name: str):
    """The `read(ctx)` of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{_named(name)}.py"
    module_name = "genie_bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
