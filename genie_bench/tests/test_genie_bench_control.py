"""The comparison that decides `correct`, shown to fail: a run of each cell at
a small size on the CPU (the look for a chip skipped) is correct as it
stands; the control is read as faulty; and a run with the timed path
broken underneath comes out not correct, once for each fault a search can
have: half of the batch left out (its answers taken from the other half),
and an answer altered where it is produced."""
import pytest
import torch

from genie_bench import run
from genie_bench.harness import control
from genie_bench.tests.tiny import CELLS, one_thread, tiny_cell  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _run(name: str, trace: bool = False, seed: int = 2 ** 33 + 5) -> dict:
    return run.run_cell(tiny_cell(name), seed, 0.3, trace, CPU, 0.0)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, trace):
    got = _run(name, trace)
    assert got["correct"] and got["checks"] == {"answer_faults": {"value": 0, "limit": 0}}
    assert got["attempted"] > 0 and got["failed"] == 0
    assert list(got)[-1] == "checks"
    wanted = {"search.roofline_pct"} if trace else {"queries_per_s", "peak_device_gb", "setup_s"}
    assert wanted <= set(got["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_read_as_faulty(name):
    readings = control.readings(tiny_cell(name), [7, 8, 9], CPU)
    assert min(readings) > 0, readings


def _half_left_out(search):
    def broken(self, batch):
        half = batch.shape[0] // 2
        out = search(self, batch[:half])
        return {k: None if v is None else torch.cat([v, v[:batch.shape[0] - half]])
                for k, v in out.items()}
    return broken


def _altered(search):
    def broken(self, batch):
        out = search(self, batch)
        ids = out["ids"].clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.n_objects
        return dict(out, ids=ids)
    return broken


@pytest.mark.parametrize("fault", [_half_left_out, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    system = cell.system().System
    monkeypatch.setattr(system, "search", fault(system.search))
    monkeypatch.setattr(system, "n_objects", cell.cfg["n_objects"], raising=False)
    got = run.run_cell(cell, 11, 0.3, False, CPU, 0.0)
    assert not got["correct"] and got["checks"]["answer_faults"]["value"] > 0
