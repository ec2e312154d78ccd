"""Cells cut down to a size the CPU runs in a second, for the tests."""
import sys

import pytest
import torch

from genie_bench.harness import cell as cell_lib
from genie_bench.harness.program import ROOT, SRC

if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

SIZES = {
    "sift-e2lsh": dict(n_objects=3200, segments=4, dim=16, m=64, k=10, check_queries=64),
    "dblp-minsum": dict(n_objects=2000, segments=4, k=8, check_queries=64),
}
# each loop's mix at the tests' size
MIXES = {
    "closed": dict(batch=32, warm_requests=1, trace_requests=2),
    "open": dict(rate=40, max_batch=64, trace_requests=4, drain_s=20),
}
CELLS = ("sift-e2lsh.batch1024", "dblp-minsum.batch1024")


def tiny_cell(name: str, root=ROOT, **sizes):
    """The cell `name` of `root/BENCHMARK.json` at the tests' size (and
    `sizes` on top)."""
    cell = cell_lib.load(root, name)
    cell.cfg.update(SIZES[cell.cfg["name"]], **sizes)
    if "k" in cell.mix:
        cell.cfg["k"] = cell.mix["k"]
    cell.mix = dict(cell.mix, **MIXES[cell.mix["loop"]])
    return cell


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One CPU thread for torch while a module of these tests runs: the test
    run's workers share the cores, and torch's thread pools, each as wide as
    the machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
