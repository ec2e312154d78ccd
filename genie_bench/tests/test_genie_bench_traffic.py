"""Traffic as data: a mix names its loop, the query stream sends no row
twice, and a cell of another loop is a new mix file and new entries alone."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from genie_bench import run
from genie_bench.harness import traffic
from genie_bench.harness.program import ROOT, SRC
from genie_bench.tests.test_genie_bench_trace import slow_run
from genie_bench.tests.tiny import one_thread  # noqa: F401  (autouse)
from genie_bench.tests.test_genie_bench_contract import ONE_THREAD

CLOSED = {"loop": "closed", "batch": 4, "warm_requests": 1, "trace_requests": 1}
OPEN = {"loop": "open", "rate": 10, "batch": 1, "max_batch": 8, "max_wait_us": 2000,
        "max_queue": 256, "trace_requests": 2}


@pytest.mark.parametrize("mix", [CLOSED, OPEN, dict(CLOSED, k=5), dict(OPEN, drain_s=5)])
def test_a_mix_of_its_loops_keys_is_taken(mix):
    assert traffic.check_mix(dict(mix)) == mix


@pytest.mark.parametrize("mix", [
    dict(CLOSED, loop="nowhere"), dict(CLOSED, loop="../closed"), {"batch": 4},
    {k: v for k, v in CLOSED.items() if k != "warm_requests"}, dict(CLOSED, draws=8),
    dict(CLOSED, drain_s=5), dict(CLOSED, batch=0)])
def test_a_mix_that_is_not_its_loops_is_refused(mix):
    with pytest.raises((ValueError, ModuleNotFoundError)):
        traffic.check_mix(mix)


def test_the_stream_makes_blocks_late_only_past_what_was_made():
    r = slow_run(0.0, block_rows=4)
    r.stream.make(6)                                   # two blocks of 4
    assert r.stream.rows_made == 8 and r.stream.blocks_made_late == 0
    a, b, c = r.send(3), r.send(3), r.send(4)          # b straddles two blocks; c needs a third
    assert r.stream.blocks_made_late == 1
    assert [x["rows"].tolist() for x in (a, b, c)] == [[0, 1, 2], [3, 4, 5], [6, 7, 8, 9]]
    raw = r.stream.raw_rows(torch.tensor([9, 0, 5]))
    assert raw[:, 0].tolist() == [2.0, 0.0, 1.0]


def test_a_missing_end_to_end_reading_is_refused():
    class Cell:
        name = "c"
        end_to_end = [{"name": "queries_per_s", "unit": "queries/s"},
                      {"name": "request_p95_ms", "unit": "ms"}]
    got = run.end_to_end(Cell, {"queries_per_s": 3.0, "request_p95_ms": 9.5, "other": 1})
    assert got == {"queries_per_s": {"value": 3.0, "unit": "queries/s"},
                   "request_p95_ms": {"value": 9.5, "unit": "ms"}}
    with pytest.raises(KeyError, match="request_p95_ms"):
        run.end_to_end(Cell, {"queries_per_s": 3.0, "request_p95_ms": None})


def test_an_open_loop_cell_is_a_new_mix_file_and_new_entries(tmp_path):
    """A copy of the benchmark gains `traffic/single-open.json`, a cell on it
    and two end-to-end metrics; with no file of the copy changed, a run of
    that cell on the CPU (through the program's serving front-end) takes
    its tails and is correct."""
    shutil.copytree(ROOT / "genie_bench", tmp_path / "genie_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "genie_bench" / "traffic" / "single-open.json").write_text(json.dumps(
        {"loop": "open", "rate": 40, "batch": 1, "k": 10, "max_batch": 1024,
         "max_wait_us": 2000, "max_queue": 256, "trace_requests": 8}))
    bench["workloads"].append({"name": "sift-e2lsh.single-open", "config": "sift-e2lsh",
                               "traffic": "single-open", "chips": 1, "why": "Q = 1 arrivals"})
    for name in ("request_p50_ms", "request_p95_ms"):
        bench["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                    "bound": 0.1, "source": "host_clock",
                                    "workloads": ["sift-e2lsh.single-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys
from pathlib import Path
sys.path[:0] = [{str(tmp_path)!r}, {str(SRC)!r}]
import torch
import genie_bench, genie_bench.run
from genie_bench.tests.tiny import tiny_cell
cell = tiny_cell("sift-e2lsh.single-open", root=Path({str(tmp_path)!r}))
got = genie_bench.run.run_cell(cell, 2 ** 35 + 3, 1.0, False, torch.device("cpu"), 0.0)
print(json.dumps({{"package": genie_bench.__file__, "k": cell.cfg["k"], "result": got}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=240, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["package"].startswith(str(tmp_path)) and got["k"] == 10
    res = got["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 10
    assert set(res["metrics"]) == {"queries_per_s", "peak_device_gb", "setup_s",
                                   "request_p50_ms", "request_p95_ms"}
    assert 0 < res["metrics"]["request_p50_ms"]["value"] <= res["metrics"]["request_p95_ms"]["value"]
    for f in (ROOT / "genie_bench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp_path / f.relative_to(ROOT)).read_bytes() == f.read_bytes(), f
