"""BENCHMARK.json against the contract's shapes, the files it names, the
inputs' determinism per seed, and the modules a run may load."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from genie_bench.harness import cell as cell_lib, program, traffic
from genie_bench.harness.program import ROOT
from genie_bench.tests.tiny import CELLS, one_thread, tiny_cell  # noqa: F401  (autouse)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_the_file_has_the_contracts_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_the_command_and_paths_stay_inside_the_benchmark():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")
        if (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in paths), word


def test_every_name_unit_and_line_is_well_formed():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    lines = [c[k] for c in BENCH["configs"] for k in ("why", "source")]
    lines += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(LINE.match(x) for x in lines)


def test_each_entry_has_just_its_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_set_up_is_bounded_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell = cell_lib.load(ROOT, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_named_file_is_there():
    workloads = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith(BENCH["paths"][0] + "/") and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert (ROOT / "genie_bench" / "reference" / f"{cfg['reference']}.py").is_file()
        assert (ROOT / "genie_bench" / "systems" / f"{cfg['system']}.py").is_file()
    for w in BENCH["workloads"]:
        traffic.check_mix(json.loads(
            (ROOT / "genie_bench" / "traffic" / f"{w['traffic']}.json").read_text()))
    for m in BENCH["per_layer"]:
        assert callable(cell_lib.metric_reader(m["name"]))
        assert set(m.get("workloads", workloads)) <= workloads
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(workloads)


def test_the_programs_own_kernels_are_found():
    names = program.own_kernel_names()
    assert {"match_count_kernel", "cpq_hist_kernel", "minsum_count_kernel",
            "minsum_nnz_kernel", "minsum_csr_kernel"} <= set(names)
    for w in BENCH["workloads"]:
        for k in cell_lib.load(ROOT, w["name"]).cfg["count_kernels"]:
            assert k in names


@pytest.mark.parametrize("name", CELLS)
def test_inputs_are_the_same_for_a_seed_and_differ_across_seeds(name):
    cpu = torch.device("cpu")
    cell = tiny_cell(name)
    ref, cfg = cell.reference(), cell.cfg
    seed = 2 ** 40 + 7                            # past 32 bits
    runs = []
    for s in (seed, seed, seed + 1):
        inp = ref.inputs(cfg, s, cpu)
        runs.append([*inp.values(), ref.corpus_chunk(cfg, s, inp, 1, cpu),
                     ref.queries(cfg, s, inp, [0, 1], 16, cpu)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][-2], runs[2][-2]) and not torch.equal(runs[0][-1], runs[2][-1])
    # a block is the same whichever blocks are drawn beside it
    inp = ref.inputs(cfg, seed, cpu)
    assert torch.equal(ref.queries(cfg, seed, inp, [1], 16, cpu), runs[0][-1][16:])


def test_forbidden_modules_compare_whole_top_level_names():
    assert program.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping", "reprox"]) == []
    assert program.forbidden_modules(["repro", "repro.core.plan", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core.plan"]


# one CPU thread in a child as in the tests (see tiny.one_thread)
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=240, env=ONE_THREAD)


def test_a_run_loads_neither_jax_nor_the_jax_package_and_the_reference_no_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import genie_bench.run, genie_bench.harness.control, genie_bench.tools.control_readings
import genie_bench.reference.e2lsh_eq, genie_bench.reference.ngram_minsum
from genie_bench.harness.program import forbidden_modules
before = sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')
from genie_bench.tests.tiny import tiny_cell
import torch
for name in {list(CELLS)!r}:
    cell = tiny_cell(name)
    genie_bench.run.run_cell(cell, 3, 0.2, False, torch.device('cpu'), 0.0)
print(json.dumps({{"forbidden": forbidden_modules(), "port_before_a_run": before,
                  "port_after": 'repro_torch' in sys.modules}}))
"""
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port_before_a_run": [], "port_after": True}


def test_without_a_device_or_the_program_a_run_prints_no_result(tmp_path):
    """No CUDA here: the run exits non-zero with nothing on stdout; the same
    in a directory holding only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "genie_bench", tmp_path / "genie_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "genie_bench/run.py", "--workload",
                              CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=root, capture_output=True, text=True, timeout=240,
                             env=ONE_THREAD)
        assert out.returncode != 0 and out.stdout == ""
