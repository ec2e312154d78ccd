"""The control of the comparison that decides `correct`: the reference put
in the program's place, computed in the nearest precision below the one
the configuration states (or, where it states none, with one of its
guarantees broken: reference/<name>.py `control_answers`), and judged as a
run's answers are.  A sound comparison reads it as faulty; the benchmark's
own runs never run it (tools/control_readings.py does, on the card;
tests/test_genie_bench_control.py at a small size)."""
from __future__ import annotations

import math

import torch

from genie_bench.harness.traffic import BLOCK_ROWS
from genie_bench.reference.topk import malformed_rows


def reading(cell, seed: int, device) -> int:
    """`answer_faults` of the control's answers to the first queries of the
    query stream of `seed` (as many as a run checks)."""
    cfg, ref = cell.cfg, cell.reference()
    inp = ref.inputs(cfg, seed, device)
    n = cfg["check_queries"]
    queries = ref.queries(cfg, seed, inp, range(math.ceil(n / BLOCK_ROWS)), BLOCK_ROWS,
                          device)[:n]
    got = ref.control_answers(cfg, seed, inp, queries, device)
    faults = ref.evaluate(cfg, seed, inp, queries, got, None, device)
    return faults["answer_faults"] + malformed_rows(
        got["ids"].numpy(), got["counts"].numpy(), got["threshold"].numpy(), cfg["n_objects"])


def readings(cell, seeds, device) -> list:
    out = []
    for seed in seeds:
        out.append(reading(cell, seed, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out
