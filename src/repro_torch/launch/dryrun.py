"""Dry-run: what each LM cell and each of the paper's datasets costs the port
per rank, without building anything.

    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k --mesh multi
    python -m repro_torch.launch.dryrun --genie [--world 1|4] [--n-queries Q]

The counterpart of `repro/launch/dryrun.py`.

LM cells (`run_lm_cell`): every architecture x `shapes.SHAPES` x mesh, on the
reference's meshes -- `single` (data 16, model 16) and `multi` (pod 2,
data 16, model 16), read as that many H100 ranks -- and on the port's GENIE
worlds, `world1` (1, 1) and `world4` (1, 4).  A cell is analytic and per
rank: it needs only the mesh's axis sizes and no process group.  It
reports the reference's skip rules and reasons, its analytic fields
(`param_count`, `active_param_count`, `tokens_per_step`, `model_flops`),
its microbatch and moment-dtype rules (`accum`, `moment_dtype`), the policy
(`use_tp`: training takes `cfg.use_tp`, prefill and decode
`cfg.use_tp_serve`), and

  * `memory.per_rank`: bytes by term from the per-rank shard shapes of
    `launch/sharding.py`'s specs -- params, moments, gradients (and their
    float32 accumulator when accum > 1), compress_error where compression
    is on, batch, cache (decode) and logits -- plus `activations`, THE
    PORT'S OWN MODEL (`activation_bytes`), not a measurement; then `peak`
    (their sum) and `fits` against `card_bytes()`;
  * `collectives`: the bytes one rank sends in one step, by type, from the
    policy's own arithmetic (`collective_bytes`): the FSDP all-gathers of
    the weights (forward and the remat recompute), the gradients'
    reduce-scatters over the FSDP group and all-reduces over the replicas,
    TP's row-parallel activation all-reduces, and the decode cache gathered
    where its length is sharded.  Ring collectives: an all-gather or
    reduce-scatter over n ranks sends (n - 1) shards, an all-reduce
    2 (n - 1) / n of the tensor.

XLA's `cost_analysis`, `memory_analysis` and the unrolled cost extrapolation
of the reference have no counterpart: PyTorch compiles nothing ahead of a
run, so the port states its memory and traffic from the policy instead.

GENIE cells (`run_genie_cell`, `main --genie`).  The reference lowers and compiles the
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

Reports go to `reports/dryrun_torch/lm__<arch>__<shape>__<mesh>.json` and
`reports/dryrun_torch/genie__<dataset>__search_<Q>q__world<W>.json`.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS
from repro_torch.configs.genie_datasets import DATASETS
from repro_torch.core import engines as engines_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import segments as seg_lib
from repro_torch.core.types import SearchParams
from repro_torch.kernels.cpq_compact import SMEM_TIES
from repro_torch.launch import shapes as shapes_lib
from repro_torch.launch import sharding as sh_lib
from repro_torch.models.registry import get_api, get_config
from repro_torch.tree import leaves

REPORT_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                          "reports", "dryrun_torch"))

# the card's memory where none is present to ask (an H100 80GB)
CARD_BYTES_DEFAULT = 80 * 2**30
COUNT_BYTES = 4            # the match kernels write int32 counts
INGEST_SEGMENTS = 16       # the corpus arrives in 16 add() batches ...
COMPACT_EVERY = 2          # ... compacted 2:1 at serve time
# The c-PQ compaction (`kernels/cpq_compact`, one read of the [Q, N_part]
# count matrix) holds no [Q, N_part] temporary: beside its [Q, cap] outputs
# only a [Q, cap] int32 scratch for the ties, where cap exceeds the shared
# memory's SMEM_TIES (the chunked cut's per-chunk numbers are a few KB).


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
                 placed_rows: int, query_bytes: int, max_count: int, cap: int,
                 masked: bool = False) -> dict:
    """Per-rank device bytes of one search, by term.

    `segments`: the service's segmented index, n_objects rows (every rank
    holds all of it, also on DISTRIBUTED); `placed`: a DISTRIBUTED rank's
    shard, placed beside it (0 on SEGMENTED, whose parts are the segments);
    `counts`: one part's [Q, part_rows] int32 count matrix; `pad_mask`: the
    masked copy the pad mask (`plan._mask_pad_counts`) makes of it while the
    first is alive, where the plan masks pad columns (`masked`); `compaction`:
    the c-PQ compaction kernel's tie scratch beside it ([Q, cap] int32
    where cap > SMEM_TIES, else none); `queries`, `histogram` and `buffers`
    (a part's [Q, cap] ids and counts, and as much again for the merge) are
    small."""
    counts = n_queries * part_rows * COUNT_BYTES
    terms = dict(
        segments=n_objects * row_bytes,
        placed=placed_rows * row_bytes,
        counts=counts,
        pad_mask=counts if masked else 0,
        compaction=0 if cap <= SMEM_TIES else n_queries * cap * 4,
        queries=n_queries * query_bytes,
        histogram=n_queries * (max_count + 1) * 4,
        buffers=4 * n_queries * cap * 4,
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
                          max_count=params.max_count, cap=params.cap(),
                          masked=plan.n_objects is not None)
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


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "world1": {"data": 1, "model": 1},
    "world4": {"data": 1, "model": 4},
}
_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
          torch.int64: 8}


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[name]


def spec_size(entry, axes: dict) -> int:
    """How many ranks one spec entry splits a dim over."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axes[a] for a in names)


def shard_shape(shape: tuple, spec: tuple, axes: dict) -> tuple:
    """One rank's shard of `shape` under `spec` (every sharded dim divides:
    the policy shards only where it does)."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = spec_size(entry, axes)
        assert n % k == 0, (shape, spec)
        out.append(n // k)
    return tuple(out)


def _shard_bytes(t, spec, axes) -> int:
    return math.prod(shard_shape(tuple(t.shape), spec, axes)) * _BYTES[t.dtype]


def lm_accum(cfg, shape, axes: dict, use_tp: bool) -> int:
    """The reference's microbatch rule: each microbatch holds <= 8k tokens a
    data-parallel rank."""
    dp = math.prod(axes[a] for a in sh_lib._dp_axes(axes)) * (1 if use_tp else axes["model"])
    tokens_per_dev = shape.global_batch * shape.seq_len // dp
    accum = 1
    while tokens_per_dev // accum > 8192 and shape.global_batch % (2 * accum) == 0:
        accum *= 2
    return accum


def moment_dtype(cfg) -> str:
    """bfloat16 Adam moments above 100 B parameters (the reference's rule)."""
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"


def _param_groups(spec: tuple, axes: dict, use_tp: bool) -> tuple[int, int]:
    """(the FSDP group a leaf's shards are gathered over, the replicas its
    gradient is all-reduced over)."""
    named = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    tp_only = {"model"} if use_tp and any(e == "model" for e in spec) else set()
    fsdp = math.prod(axes[a] for a in named - tp_only)
    dp_axes = set(sh_lib._dp_axes(axes)) | (set() if use_tp else {"model"})
    replicas = math.prod(axes[a] for a in dp_axes - named)
    return fsdp, replicas


def activation_bytes(cfg, kind: str, rows: int, seq: int, axes: dict, use_tp: bool) -> int:
    """The port's own model of one rank's activation bytes beside the state
    (remat "nothing" in training), at `rows` local sequences of `seq`:

      * train: every block's input kept for the backward (the residual,
        sequence-parallel over "model" where it divides), and one block's
        recompute working set: the float32 attention scores and softmax
        weights with their gradients (4 x [rows, heads, Sq, Sk]; Sk a 1024
        chunk and Sq a 512 chunk at >= 2048) or the SSD's float32 chunk
        masks, the MLP's three [rows, S, d_ff] intermediates and their
        gradients; and the logits' float32 gradient and compute-dtype copy;
      * prefill: one block's working set forward only, and the emitted K/V
        with its padded bfloat16 cache;
      * decode: one block's working set at one position."""
    cb = _dtype_bytes(cfg.compute_dtype)
    tp = axes["model"] if use_tp else 1
    s = seq if kind != "decode" else 1
    sp = s // tp if s % tp == 0 else s
    heads = cfg.n_heads if cfg.family not in ("ssm",) else 0
    h_l = heads // tp if heads and heads % tp == 0 else heads
    kv = cfg.n_kv_heads or 0
    kv_l = kv // tp if kv and kv % tp == 0 else kv
    ff = cfg.d_ff or (cfg.moe_d_ff * cfg.experts_top_k if cfg.n_experts else 0)
    ff_l = ff // tp if ff and ff % tp == 0 else ff
    train = kind == "train"
    sk = seq if kind == "decode" else s
    if heads:
        sq_t, sk_t = (512, 1024) if (kind != "decode" and s >= 2048) else (s, sk)
        attn = rows * h_l * sq_t * sk_t * 4 * (4 if train else 2)
    else:
        attn = 0
    if cfg.family in ("ssm", "hybrid"):
        c = cfg.ssd_chunk if kind != "decode" else 1
        nh = cfg.ssm_n_heads
        nh_l = nh // tp if nh % tp == 0 else nh
        attn += rows * (s // c if kind != "decode" else 1) * nh_l * c * c * 4 * (4 if train else 2)
    mlp = rows * s * ff_l * cb * (6 if train else 3)
    layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "audio" else 0)
    total = attn + mlp
    if train:
        total += layers * rows * sp * cfg.d_model * cb
        v_l = cfg.vocab // tp if cfg.vocab % tp == 0 else cfg.vocab
        total += rows * s * v_l * (4 + cb)
    elif kind == "prefill" and kv:
        total += 2 * 2 * layers * rows * s * kv_l * cfg.head_dim * cb
    return int(total)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    cfg = get_config(arch)
    return shapes_lib.param_specs(cfg, get_api(cfg))


def run_lm_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """One (arch, shape, mesh) cell, analytic and per rank (see the module
    docstring)."""
    return lm_cell(arch, shapes_lib.SHAPES[shape_name], LM_MESHES[mesh_kind])


def lm_cell(arch: str, shape, axes: dict) -> dict:
    """`run_lm_cell` for any `shapes.ShapeSpec` and {axis: size}."""
    cfg = get_config(arch)
    api = get_api(cfg)
    supported, reason = shapes_lib.cell_supported(cfg, shape)
    if not supported:
        return dict(ok=True, skipped=True, reason=reason)
    if shape.kind == "decode" and not api.supports_decode:
        return dict(ok=True, skipped=True, reason="architecture has no decode step")
    axes = dict(axes)
    use_tp = cfg.use_tp if shape.kind == "train" else cfg.use_tp_serve
    tp = axes["model"] if use_tp else 1
    cb = _dtype_bytes(cfg.compute_dtype)

    pshapes = _param_shapes(arch)
    pspecs = sh_lib.params_specs(pshapes, axes, use_tp)
    pleaves, sleaves = leaves(pshapes), _spec_leaves(pspecs)
    params_b = sum(_shard_bytes(t, sp, axes) for t, sp in zip(pleaves, sleaves))
    shard_numel = [math.prod(shard_shape(tuple(t.shape), sp, axes))
                   for t, sp in zip(pleaves, sleaves)]
    groups = [_param_groups(sp, axes, use_tp) for sp in sleaves]
    terms: dict = dict(params=params_b)
    rep = dict(ok=True, skipped=False, arch=arch, mesh_axes=axes, use_tp=use_tp)

    if shape.kind == "decode":
        batch = {"t": shapes_lib.token_specs(cfg, shape)}
    else:
        batch = shapes_lib.input_specs(cfg, shape)
    bspecs = sh_lib.batch_specs(batch, axes, use_tp)
    terms["batch"] = sum(_shard_bytes(t, bspecs[k], axes) for k, t in batch.items())
    b_local = shape.global_batch // spec_size(bspecs[next(iter(bspecs))][0], axes)
    v_l = cfg.vocab // tp if cfg.vocab % tp == 0 else cfg.vocab
    coll = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    gather = sum((f - 1) * n * cb for (f, _), n in zip(groups, shard_numel))
    n_rowpar = {"ssm": 1, "hybrid": 1}.get(cfg.family, 2)
    layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "audio" else 0)

    def tp_all_reduce(rows, s, passes):
        if tp == 1:
            return 0
        return int(passes * layers * n_rowpar * 2 * (tp - 1) / tp * rows * s * cfg.d_model * cb)

    if shape.kind == "train":
        accum = lm_accum(cfg, shape, axes, use_tp)
        mdt = moment_dtype(cfg)
        terms["moments"] = 2 * sum(shard_numel) * _dtype_bytes(mdt)
        terms["gradients"] = params_b * (2 if accum > 1 else 1)
        rows = b_local // accum
        terms["logits"] = rows * shape.seq_len * v_l * 4
        terms["activations"] = activation_bytes(cfg, "train", rows, shape.seq_len, axes, use_tp)
        coll["all-gather"] = accum * 2 * gather
        coll["reduce-scatter"] = accum * sum((f - 1) * n * 4
                                             for (f, _), n in zip(groups, shard_numel))
        coll["all-reduce"] = accum * int(sum(2 * (r - 1) / r * n * 4
                                             for (_, r), n in zip(groups, shard_numel)))
        coll["all-reduce"] += accum * tp_all_reduce(rows, shape.seq_len, 3)
        rep.update(accum=accum, moment_dtype=mdt)
    elif shape.kind == "prefill":
        terms["logits"] = b_local * shape.seq_len * v_l * 4
        terms["activations"] = activation_bytes(cfg, "prefill", b_local, shape.seq_len, axes,
                                                use_tp)
        coll["all-gather"] = gather
        coll["all-reduce"] = tp_all_reduce(b_local, shape.seq_len, 1)
    else:
        cache = shapes_lib.cache_specs(cfg, shape)
        cspecs = sh_lib.cache_specs(cfg, cache, axes)
        terms["cache"] = sum(_shard_bytes(t, cspecs[k], axes) for k, t in cache.items())
        terms["logits"] = b_local * v_l * 4
        terms["activations"] = activation_bytes(cfg, "decode", b_local, shape.seq_len, axes,
                                                use_tp)
        coll["all-gather"] = gather
        for k, t in cache.items():      # a sharded cache length is gathered a layer a step
            if k in ("k", "v", "attn_k", "attn_v"):
                n = spec_size(cspecs[k][2], axes)
                coll["all-gather"] += (n - 1) * _shard_bytes(t, cspecs[k], axes)
        coll["all-reduce"] = tp_all_reduce(b_local, 1, 1)
    terms["peak"] = sum(terms.values())
    card, source = card_bytes()
    n_params, n_active = cfg.param_count(), cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    rep.update(
        param_count=int(n_params), active_param_count=int(n_active),
        tokens_per_step=int(tokens), model_flops=float(factor * n_active * tokens),
        memory=dict(per_rank=terms, card_bytes=card, card_bytes_source=source,
                    fits=terms["peak"] <= card),
        collectives=coll,
    )
    return rep


def _spec_leaves(specs) -> list:
    """The spec tuples of a tree of specs, in the order of `tree.leaves`."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for node in specs for x in _spec_leaves(node)]
    return [specs]


def lm_cell_path(arch: str, shape: str, mesh_kind: str) -> str:
    os.makedirs(REPORT_DIR, exist_ok=True)
    return os.path.join(REPORT_DIR, f"lm__{arch}__{shape}__{mesh_kind}.json")


def run_and_save_lm(arch: str, shape: str, mesh_kind: str, force: bool = False) -> dict:
    """One LM cell, its report written (an existing report is read back
    unless `force`)."""
    path = lm_cell_path(arch, shape, mesh_kind)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rep = run_lm_cell(arch, shape, mesh_kind)
    rep.update(kind="lm", name=arch, shape=shape, mesh=mesh_kind)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    if rep.get("skipped"):
        status = f"SKIP ({rep['reason']})"
    else:
        mem = rep["memory"]
        gb = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in mem["per_rank"].items())
        status = f"fits={mem['fits']} GB a rank: {gb}"
    print(f"[dryrun] lm {arch} {shape} {mesh_kind}: {status}", flush=True)
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shapes_lib.SHAPES))
    ap.add_argument("--mesh", default=None, choices=list(LM_MESHES))
    ap.add_argument("--genie", action="store_true", help="run the GENIE search cells")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--world", type=int, default=None, choices=[1, 4])
    ap.add_argument("--n-queries", type=int, default=None)
    args = ap.parse_args(argv)
    if args.genie or args.all:
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
    if not args.genie or args.all:
        archs = [args.arch] if args.arch else ALL_ARCHS
        shapes = [args.shape] if args.shape else list(shapes_lib.SHAPES)
        meshes = [args.mesh] if args.mesh else list(LM_MESHES)
        for arch in archs:
            for shape in shapes:
                for mk in meshes:
                    run_and_save_lm(arch, shape, mk, args.force)


if __name__ == "__main__":
    main()
