"""The benchmark of `repro_torch`, the PyTorch and CUDA port of GENIE.

One command runs one cell once (see `run.py`).  Everything a cell needs is
found by the names in the repository's `BENCHMARK.json`:

    configs/<config>.json        a deployment: its source, shapes, cuts, guarantee
    traffic/<traffic>.json       a traffic mix: its `loop` and that loop's parameters
    loops/<loop>.py              a traffic loop (closed, open): it sends the
                                 requests and takes the end-to-end readings by name
    systems/<system>.py          how the deployment drives the program under test
    reference/<reference>.py     its inputs, plain reference and least-work count
    metrics/<metric>.py          one reader per per-layer metric

Nothing here imports JAX or the JAX package `repro`; only `systems/`,
`loops/open.py` and the tests import `repro_torch`.  `tools/` holds
what is run on the card apart from the cells: the control's readings and the
front-end's knee.
"""
