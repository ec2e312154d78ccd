"""GENIE dry-run: what each of the paper's datasets costs the port on a world
of one or four H100s, without building anything.

    python -m repro_torch.launch.dryrun --genie [--world 1|4] [--n-queries Q]

The counterpart of the GENIE cells of `repro/launch/dryrun.py`
(`run_genie_cell`, `main --genie`).  The reference lowers and compiles the
search step for a 256- or 512-device TPU mesh and reads XLA's memory and cost
analyses; PyTorch has no such compiler pass, so each cell here reports the
same analytic fields from the port's own objects, and a per-rank memory
model in place of `memory_analysis()`:

  * `plan`: `describe()` of the plan that serves the dataset (SEGMENTED over
    the compacted segments on a world of 1, DISTRIBUTED over the ranks'
    shards on 4);
  * `model_flops`: Q * N * width signature compares;
  * `kernel_model`: the match + histogram kernels' operations and bytes per
    rank (the reference's formula, with the port's element sizes);
  * `segmented`: the ingest (16 adds) and compacted (2:1) layouts'
    accounting, pad rows, and wide / PACKED signature bytes;
  * `memory`: the per-rank memory model (`memory_model`) and whether it
    `fits` the card.

Element sizes.  The reference stores EQ signatures in the narrowest integer
that holds the rehash domain and MINSUM / IP vectors as int8; the element
size here is what the port's engine prepares from that same dtype
(`MatchModel.prepare_data`): int32 for EQ, MINSUM and RANGE, int8 kept for
IP.  Counts are int32 in the port (the reference's kernel model counts one
byte a count).

Reports go to `reports/dryrun_torch/genie__<dataset>__search_<Q>q__world<W>.json`.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.genie_datasets import DATASETS
from repro_torch.core import engines as engines_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import segments as seg_lib
from repro_torch.core.types import SearchParams

REPORT_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                          "reports", "dryrun_torch"))

# the card's memory where none is present to ask (an H100 80GB)
CARD_BYTES_DEFAULT = 80 * 2**30
COUNT_BYTES = 4            # the match kernels write int32 counts
INGEST_SEGMENTS = 16       # the corpus arrives in 16 add() batches ...
COMPACT_EVERY = 2          # ... compacted 2:1 at serve time
# The c-PQ compaction (`core/cpq.py::_compact_candidates`) at its peak holds,
# beside the [Q, N_part] int32 count matrix C: the `strict` mask (C / 4),
# the tie positions `pos` (C), the strict cumsum minus one (C) and the next
# `pos` (C) -- 3.25 C more, 4.25 C in all.
COMPACTION_TRANSIENT = 3.25


def _reference_dtype(ds) -> np.dtype:
    """The dtype the reference's dry-run gives the dataset's signatures."""
    if ds.engine == "eq":
        return np.dtype(np.int8 if ds.n_buckets <= 127 else
                        np.int16 if ds.n_buckets <= 32767 else np.int32)
    if ds.engine in ("minsum", "ip"):
        return np.dtype(np.int8)
    return np.dtype(np.int32)


def width_of(ds) -> int:
    return ds.m if ds.engine != "range" else ds.dim


def element_bytes(ds) -> int:
    """Bytes of one signature element as the port's engine prepares the
    reference's dtype."""
    sample = np.zeros((1, width_of(ds)), dtype=_reference_dtype(ds))
    prepared = engines_lib.get(ds.engine).prepare_data(sample, torch.device("cpu"))
    return int(prepared.element_size())


def search_params(ds) -> SearchParams:
    """k and the count bound of the dataset's search (the reference's)."""
    max_count = {"eq": ds.m, "minsum": 127, "ip": ds.dim * 4, "range": ds.dim}[ds.engine]
    return SearchParams(k=ds.default_k, max_count=max_count)


def card_bytes() -> tuple[int, str]:
    """(bytes of device memory, where the figure comes from)."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"torch.cuda.get_device_properties(0): {props.name}"
    return CARD_BYTES_DEFAULT, "80 GiB: no card present"


def memory_model(*, n_objects: int, row_bytes: int, n_queries: int, part_rows: int,
                 placed_rows: int, query_bytes: int, max_count: int, cap: int) -> dict:
    """Per-rank device bytes of one search, by term.

    `segments`: the service's segmented index, n_objects rows (every rank
    holds all of it, also on DISTRIBUTED); `placed`: a DISTRIBUTED rank's
    shard, placed beside it (0 on SEGMENTED, whose parts are the segments);
    `counts`: one part's [Q, part_rows] int32 count matrix; `compaction`:
    the c-PQ compaction's transient beside it (COMPACTION_TRANSIENT x);
    `queries`, `histogram` and `buffers` (a part's [Q, cap + 1] ids and
    counts, and as much again for the merge) are small."""
    counts = n_queries * part_rows * COUNT_BYTES
    terms = dict(
        segments=n_objects * row_bytes,
        placed=placed_rows * row_bytes,
        counts=counts,
        compaction=int(COMPACTION_TRANSIENT * counts),
        queries=n_queries * query_bytes,
        histogram=n_queries * (max_count + 1) * 4,
        buffers=4 * n_queries * (cap + 1) * 4,
    )
    terms["peak"] = sum(terms.values())
    return terms


def run_genie_cell(dataset: str, world: int = 1, *,
                   n_queries: Optional[int] = None) -> dict:
    """One dataset's cell on a world of `world` H100s: SEGMENTED on 1,
    DISTRIBUTED on 4; `n_queries` defaults to the dataset's batch."""
    if world not in (1, 4):
        raise ValueError(f"world must be 1 or 4, got {world}")
    ds = DATASETS[dataset]
    q = n_queries or ds.queries_per_batch
    params = search_params(ds)
    width = width_of(ds)
    sig_bytes = element_bytes(ds)
    row_bytes = width * sig_bytes
    ingest_rows = seg_lib.even_segments(ds.n_objects, INGEST_SEGMENTS)
    compacted_rows = [sum(ingest_rows[i:i + COMPACT_EVERY])
                      for i in range(0, len(ingest_rows), COMPACT_EVERY)]

    if world > 1:
        # shards of the corpus padded up to a multiple of the world, the pad
        # rows masked by n_objects (SegmentedIndex.concat_data)
        n = -(-ds.n_objects // world) * world
        n_local = n // world
        plan = plan_lib.plan_search(ds.engine, params.k, params.max_count,
                                    layout=plan_lib.Layout.DISTRIBUTED,
                                    n_objects=ds.n_objects, mesh_axes=("data",))
        part_rows, placed_rows = n_local, n_local
    else:
        n = n_local = ds.n_objects
        plan = plan_lib.plan_search(ds.engine, params.k, params.max_count,
                                    layout=plan_lib.Layout.SEGMENTED, part_rows=compacted_rows)
        part_rows, placed_rows = max(compacted_rows), 0

    kernel_flops = float(q) * n_local * width + float(q) * n_local      # match + hist
    if ds.engine == "ip":
        kernel_flops = 2.0 * q * n_local * width
    kernel_bytes = (n_local * width * sig_bytes                 # signatures, read once
                    + q * width * sig_bytes                     # queries
                    + 2.0 * COUNT_BYTES * q * n_local)          # counts write + hist read

    model = engines_lib.get(ds.engine)
    packed_row_bytes = None
    if model.supports_packed:
        packed_row_bytes = int(model.packed_bytes(torch.empty((1, width), device="meta")))
    memory = memory_model(n_objects=ds.n_objects, row_bytes=row_bytes, n_queries=q,
                          part_rows=part_rows, placed_rows=placed_rows, query_bytes=row_bytes,
                          max_count=params.max_count, cap=params.cap())
    card, source = card_bytes()
    return dict(
        ok=True, dataset=dataset, world=world, engine=ds.engine, layout=plan.layout.value,
        n_objects=int(n), n_queries=int(q), plan=plan.describe(),
        element_bytes=sig_bytes, reference_element_bytes=_reference_dtype(ds).itemsize,
        model_flops=float(q) * n * width,
        kernel_model=dict(flops=kernel_flops, bytes_accessed=kernel_bytes),
        segmented=dict(
            pad_rows=int(n - ds.n_objects),
            ingest=seg_lib.layout_accounting(ingest_rows, row_bytes),
            compacted=seg_lib.layout_accounting(compacted_rows, row_bytes),
            signatures=dict(
                packed_supported=model.supports_packed,
                bytes_per_object_wide=int(row_bytes),
                bytes_per_object_packed=packed_row_bytes,
                ingest_packed=(seg_lib.layout_accounting(ingest_rows, packed_row_bytes)
                               if packed_row_bytes else None),
                compacted_packed=(seg_lib.layout_accounting(compacted_rows, packed_row_bytes)
                                  if packed_row_bytes else None),
            ),
        ),
        memory=dict(per_rank=memory, card_bytes=card, card_bytes_source=source,
                    fits=memory["peak"] <= card),
    )


def cell_path(dataset: str, n_queries: int, world: int) -> str:
    os.makedirs(REPORT_DIR, exist_ok=True)
    return os.path.join(REPORT_DIR, f"genie__{dataset}__search_{n_queries}q__world{world}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genie", action="store_true", help="run the GENIE search cells")
    ap.add_argument("--world", type=int, default=None, choices=[1, 4])
    ap.add_argument("--n-queries", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.genie:
        ap.error("only the GENIE cells are ported: pass --genie")
    worlds = [args.world] if args.world else [1, 4]
    for name in DATASETS:
        for world in worlds:
            rep = run_genie_cell(name, world, n_queries=args.n_queries)
            path = cell_path(name, rep["n_queries"], world)
            with open(path, "w") as f:
                json.dump(rep, f, indent=1)
            mem = rep["memory"]
            print(f"[dryrun] genie {name} world {world} {rep['layout']}: peak "
                  f"{mem['per_rank']['peak'] / 1e9:.3f} GB a rank, fits={mem['fits']} "
                  f"({mem['card_bytes_source']}) -> {path}", flush=True)


if __name__ == "__main__":
    main()
