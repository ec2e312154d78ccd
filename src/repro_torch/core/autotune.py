"""Hardware-aware plan autotuner: measured cost for tile/layout/routing knobs.

The counterpart of `repro/core/autotune.py`, name for name.  GENIE's
pipeline runs at the card's limits only when its discrete knobs match the
machine: the kernels' block shapes (the tile_q / tile_n / tile_v / tile_m
kwargs of kernels/ops.py, which pick among the shapes each kernel was
compiled in -- `ops.VARIANTS`), fused vs. unfused packed match, SEGMENTED
vs. MULTILOAD host-loop part layout, the per-part `candidate_cap`, and the
routing probe width `nprobe`.  The right values differ per card, engine and
corpus shape, so this module closes the loop by *measuring*:

  * `tune()` greedily walks the knob space one axis at a time, timing real
    executions of real plans through `core.plan.execute` (median of
    `repeats`, after a warmup) in interleaved head-to-heads, and never adopts
    a knob that does not beat the incumbent;
  * winners persist as `TunedEntry` rows in an `AutotuneCache` -- a JSON file
    keyed on a hardware fingerprint (platform, device kind, device count,
    memory, the torch and CUDA versions) and a corpus-shape bucket, so tuning
    runs once per machine and a cache copied to other hardware, or written
    by the JAX package, keeps the defaults;
  * `plan_search(autotune=...)` consults the cache via `consult()` and fills
    only the knobs the caller left unset; a miss (or fingerprint mismatch)
    keeps the defaults, so tuned serving can never be worse than untuned by
    construction -- `tune()` stores the default knobs when no candidate beats
    them.

Differences from the reference, by design:

  * Time is the wall clock between two `torch.cuda.synchronize(device)`
    calls, not CUDA events: the nprobe axis trades the router's host work
    (numpy, on the host clock) against skipped segments, and the layout axis
    trades host-loop orchestration; events on the stream would see neither.
  * `price_plan(mode="lower")` has no XLA cost model to read: it returns the
    analytic work of the plan's kernels (bytes in and out once; compares,
    adds or int8 products), the formulas of the bound column of PERF.md §6,
    and executes nothing.
  * Candidates are deduplicated by the block shape a value selects
    (`kernels.common.pick_variant`), not by a clamped Pallas tile, and a
    shape whose shared memory exceeds the block's budget (`smem_budget_bytes`
    of the device, `SMEM_BUDGET_BYTES` when given) is never measured, in
    place of the reference's 12 MiB VMEM prune.
  * `setup_platform` has no counterpart: it sets XLA flags and the JAX
    platform before the backend starts, and PyTorch has neither (the device
    is chosen per call by `device=`).
  * The cache is the port's own file (`default_cache_path`, under
    `GENIE_TORCH_AUTOTUNE_CACHE`), so the two packages never overwrite each
    other's, and a cache keeps the device it was made for.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import engines as _engines
from repro_torch.core import plan as _plan
from repro_torch.core.routing import Routing
from repro_torch.core.types import Engine, SignatureLayout, TopKMethod
from repro_torch.device import DeviceLike, resolve_device, synchronize

# ---------------------------------------------------------------------------
# Hardware fingerprint + shape bucketing (the cache key axes)
# ---------------------------------------------------------------------------

CACHE_VERSION = 1
# The shared-memory budget of a block that prunes candidate shapes: None
# reads the device's own (`smem_budget_bytes`); an int overrides it.
SMEM_BUDGET_BYTES: Optional[int] = None
# On the CPU the plain versions run and no shape is too large.
CPU_SMEM_BUDGET_BYTES = 1 << 62

_CACHE_ENV = "GENIE_TORCH_AUTOTUNE_CACHE"


def hardware_fingerprint(device: DeviceLike = None) -> dict:
    """Identity of the machine a measurement is valid for.

    Platform + device kind + device count + per-device memory + the torch
    and CUDA versions: a tuned shape is a statement about one card, so any
    of these changing invalidates the cache (lookup returns None -> default
    knobs).  `device=None` means the card, and raises where there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return {
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(index),
            "device_count": torch.cuda.device_count(),
            "memory_bytes": int(torch.cuda.get_device_properties(index).total_memory),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    return {
        "platform": dev.type,
        "device_kind": dev.type,
        "device_count": 1,
        "memory_bytes": None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def smem_budget_bytes(device: DeviceLike = None) -> int:
    """The most shared memory a block may ask for on `device`
    (`shared_memory_per_block_optin`, 232,448 bytes on an H100); on the CPU
    a budget that admits every shape."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return CPU_SMEM_BUDGET_BYTES
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(index).shared_memory_per_block_optin)


def shape_bucket(n: int) -> int:
    """Corpus-shape bucket: next power of two >= n (floor 1).

    A measurement at n=100_000 prices n=120_000 fine; bucketing keeps the
    cache small and lookups stable as a corpus grows within its bucket.
    """
    n = int(n)
    if n < 1:
        raise ValueError(f"shape_bucket needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# TunedEntry + JSON cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TunedEntry:
    """One measured winner: the knob set for (engine, layout, shape bucket).

    `layout` is the tuned part-structure choice ("segmented" /
    "multiload_host"; None = caller's layout stands).  `fused_match` False
    suppresses the fused packed kernel even where gating allows it; None
    leaves the default gating alone.  `speedup` is default_us/measured_us
    from the final head-to-head -- 1.0 entries record "defaults already
    win here", which stops re-tuning from re-measuring a settled bucket.
    """

    engine: str
    signature_layout: str
    n_bucket: int
    w_bucket: int
    tile_overrides: tuple = ()
    fused_match: Optional[bool] = None
    layout: Optional[str] = None
    candidate_cap: Optional[int] = None
    nprobe: Optional[int] = None
    measured_us: float = 0.0
    default_us: float = 0.0
    speedup: float = 1.0

    def key(self) -> str:
        return cache_key(self.engine, self.signature_layout,
                         self.n_bucket, self.w_bucket)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tile_overrides"] = dict(self.tile_overrides)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunedEntry":
        d = dict(d)
        d["tile_overrides"] = _engines.canonical_tile_overrides(
            d.get("tile_overrides") or {})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def cache_key(engine: Engine | str, signature_layout: SignatureLayout | str,
              n_bucket: int, w_bucket: int) -> str:
    e = engine.value if isinstance(engine, Engine) else str(engine)
    s = (signature_layout.value if isinstance(signature_layout, SignatureLayout)
         else str(signature_layout))
    return f"{e}|{s}|{int(n_bucket)}|{int(w_bucket)}"


def default_cache_path() -> Path:
    """`$GENIE_TORCH_AUTOTUNE_CACHE`, else ~/.cache/genie/autotune_torch.json
    (the JAX package's is autotune.json: the two never share a file)."""
    env = os.environ.get(_CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "genie" / "autotune_torch.json"


class AutotuneCache:
    """JSON-persisted map of `TunedEntry` rows, gated on the fingerprint of
    the device it was made for (`device=None` means the card, and raises
    where there is none).

    `path=None` keeps the cache in memory (tests, one-shot tuning runs).
    A load failure of any kind degrades to an empty cache -- autotuning is
    an accelerator, never a correctness dependency.
    """

    def __init__(self, path: Optional[os.PathLike | str] = None,
                 fingerprint: Optional[dict] = None, device: DeviceLike = None):
        self.path = Path(path) if path is not None else None
        self.device = resolve_device(device)
        self.fingerprint = fingerprint or hardware_fingerprint(self.device)
        self.entries: dict[str, TunedEntry] = {}
        if self.path is not None:
            self.load()

    def compatible(self) -> bool:
        """True when the stored fingerprint matches this cache's device."""
        return self.fingerprint == hardware_fingerprint(self.device)

    def load(self) -> None:
        if self.path is None or not self.path.exists():
            return
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("version") != CACHE_VERSION:
                return
            self.fingerprint = dict(raw["fingerprint"])
            self.entries = {
                k: TunedEntry.from_dict(v)
                for k, v in raw.get("entries", {}).items()
            }
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError, AttributeError):
            # unreadable / stale-schema cache: fall back to empty (defaults)
            self.fingerprint = hardware_fingerprint(self.device)
            self.entries = {}

    def save(self) -> None:
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "version": CACHE_VERSION,
            "fingerprint": self.fingerprint,
            "entries": {k: v.to_dict() for k, v in self.entries.items()},
        }
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
        tmp.replace(self.path)

    def put(self, entry: TunedEntry) -> None:
        self.entries[entry.key()] = entry

    def lookup(self, engine: Engine | str,
               signature_layout: SignatureLayout | str,
               n: Optional[int], width: Optional[int] = None
               ) -> Optional[TunedEntry]:
        """The tuned entry for this shape, or None (= keep defaults).

        With `width` the lookup is exact; without it, any width bucket
        tuned for (engine, layout, n bucket) serves, best speedup first.
        Fingerprint mismatch -> None unconditionally.
        """
        if n is None or not self.compatible():
            return None
        nb = shape_bucket(n)
        if width is not None:
            return self.entries.get(
                cache_key(engine, signature_layout, nb, shape_bucket(width)))
        prefix = cache_key(engine, signature_layout, nb, 1).rsplit("|", 1)[0]
        hits = [v for k, v in self.entries.items()
                if k.rsplit("|", 1)[0] == prefix]
        if not hits:
            return None
        return max(hits, key=lambda e: e.speedup)


_RESOLVED: dict[tuple[str, str], AutotuneCache] = {}


def resolve_cache(spec: Any, device: DeviceLike = None) -> Optional[AutotuneCache]:
    """`autotune=` argument -> cache: True = the default per-user path,
    a str/Path = that file, an AutotuneCache = itself, None/False = off.
    File-backed caches are memoised per path and device (the one they are
    checked against, `device=None` the card), so plan_search does not
    re-read JSON per query."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, AutotuneCache):
        return spec
    dev = resolve_device(device)
    path = default_cache_path() if spec is True else Path(spec)
    key = (str(path), str(dev))
    cache = _RESOLVED.get(key)
    if cache is None:
        cache = AutotuneCache(path, device=dev)
        _RESOLVED[key] = cache
    return cache


def clear_resolved_caches() -> None:
    """Drop memoised file-backed caches (tests that rewrite cache files)."""
    _RESOLVED.clear()


def consult(spec: Any, *, engine: Engine | str,
            signature_layout: SignatureLayout | str,
            n: Optional[int], width: Optional[int] = None,
            device: DeviceLike = None) -> Optional[TunedEntry]:
    """plan_search's door: resolve the autotune spec and look the shape up.
    Any miss -- no cache, no entry, wrong machine -- returns None and the
    plan keeps its defaults."""
    cache = resolve_cache(spec, device)
    if cache is None:
        return None
    return cache.lookup(engine, signature_layout, n, width)


# ---------------------------------------------------------------------------
# Measurement + pricing
# ---------------------------------------------------------------------------


def _query_device(queries) -> torch.device:
    return _plan._first_query_tensor(queries).device


def _median_us(fn: Callable[[], Any], repeats: int, warmup: int,
               device: torch.device) -> float:
    """Median wall microseconds of fn(), each call between two synchronises
    of `device` (the host clock: host-side work counts, see the module
    docstring)."""
    for _ in range(max(warmup, 0)):
        fn()
    samples = []
    for _ in range(max(repeats, 1)):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        samples.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(samples))


def measure_plan(plan: "_plan.QueryPlan", data, queries, *,
                 router=None, route_queries=None,
                 repeats: int = 3, warmup: int = 1) -> float:
    """Median wall microseconds of one real execution of `plan` (the same
    `core.plan.execute` door serving uses), device-synchronised."""
    def run():
        return _plan.execute(plan, data, queries, router=router,
                             route_queries=route_queries)
    return _median_us(run, repeats, warmup, _query_device(queries))


def compare_plans(plan_a: "_plan.QueryPlan", plan_b: "_plan.QueryPlan",
                  data, queries, *, router=None, route_queries=None,
                  rounds: int = 5) -> tuple[float, float]:
    """Interleaved head-to-head: (median_us_a, median_us_b).

    Sequential timing is biased on a warming machine (whichever plan runs
    last wins for free); alternating single executions after a joint warmup
    cancels the drift, so this is the arbiter `tune()` trusts for the final
    tuned-vs-default verdict.
    """
    device = _query_device(queries)

    def timed(p) -> float:
        synchronize(device)
        t0 = time.perf_counter()
        _plan.execute(p, data, queries, router=router, route_queries=route_queries)
        synchronize(device)
        return (time.perf_counter() - t0) * 1e6

    timed(plan_a)
    timed(plan_b)
    a_s, b_s = [], []
    for _ in range(max(rounds, 1)):
        a_s.append(timed(plan_a))
        b_s.append(timed(plan_b))
    return float(statistics.median(a_s)), float(statistics.median(b_s))


def _kernel_work(plan: "_plan.QueryPlan", rows: int, width: int, q: int,
                 data_itemsize: int, query_bytes: int) -> dict:
    """{kernel: (operations, bytes)} of one part of `rows` rows: the bound
    column's formulas of PERF.md §6 -- inputs read once, outputs written
    once; per (query, row, column or word) pair one compare and one add (EQ,
    TANIMOTO), two compares and an add (RANGE), a min and an add (MINSUM),
    an int8 product and an add (COSINE, IP), an xor or lane test, a popcount
    and an add per word (PACKED); the histogram one add per count."""
    from repro_torch.kernels import common
    from repro_torch.kernels import ops as kops

    engine, params = plan.engine, plan.params
    data_bytes = rows * width * data_itemsize
    tiles = dict(plan.tile_overrides)
    if plan.fused_match is not None:
        name = ("packed_cosine_topk" if engine is Engine.COSINE else "packed_tanimoto_topk")
        words = width if engine is Engine.COSINE else -(-width // 4)
        tn = common.pick_variant(rows, tiles.get("tile_n") or max(kops.VARIANTS[name]["tile_n"]),
                                 kops.VARIANTS[name]["tile_n"], "tile_n")
        slots = -(-rows // tn) * min(params.k, tn)
        return {name: (3 * q * rows * words, data_bytes + query_bytes + 2 * q * slots * 4)}
    packed = plan.signature_layout is SignatureLayout.PACKED
    if packed:
        name = "packed_cosine_count" if engine is Engine.COSINE else "packed_tanimoto_count"
        words = width if engine is Engine.COSINE else -(-width // 4)
        ops = 3 * q * rows * words
    else:
        name, per_pair = {
            Engine.EQ: ("match_count", 2), Engine.TANIMOTO: ("tanimoto_count", 2),
            Engine.RANGE: ("range_count", 3), Engine.MINSUM: ("minsum_count", 2),
            Engine.IP: ("ip_count", 2), Engine.COSINE: ("cosine_count", 2),
        }[engine]
        ops = per_pair * q * rows * width
    work = {name: (ops, data_bytes + query_bytes + q * rows * 4)}
    if params.use_kernel and params.method is TopKMethod.CPQ:
        work["cpq_hist"] = (q * rows, (q * rows + q * (params.max_count + 1)) * 4)
    return work


def price_plan(plan: "_plan.QueryPlan", data, queries, *,
               mode: str = "measure", router=None, route_queries=None,
               repeats: int = 3, warmup: int = 1) -> dict:
    """Price one candidate plan.

    mode="measure": run it (measure_plan) -> {"p50_us": ...}.
    mode="lower": the analytic work of the plan's kernels without executing
    anything (`_kernel_work`: operations as "flops", bytes in and out once as
    "bytes_accessed", summed over the parts and kernels; "cost_keys" names
    what was counted).  Host-loop layouts are host-orchestrated programs and
    reject "lower", as in the reference.
    """
    if mode == "measure":
        return {
            "mode": "measure",
            "p50_us": measure_plan(plan, data, queries, router=router,
                                   route_queries=route_queries,
                                   repeats=repeats, warmup=warmup),
        }
    if mode != "lower":
        raise ValueError(f"mode must be 'measure' or 'lower', got {mode!r}")
    if plan.layout not in (_plan.Layout.MONOLITHIC, _plan.Layout.MULTILOAD) \
            or plan.host_loop:
        raise ValueError(
            f"mode='lower' needs a single lowerable program; a "
            f"{plan.layout.value}{' host-loop' if plan.host_loop else ''} "
            f"plan is host-orchestrated -- price it with mode='measure'"
        )
    if plan.engine is None:
        raise ValueError("mode='lower' prices an engine's kernels; a raw match "
                         "callable has none")
    qs = queries if isinstance(queries, (tuple, list)) else (queries,)
    q = int(qs[0].shape[0])
    query_bytes = sum(int(t.numel()) * t.element_size() for t in qs)
    parts = ([data[i] for i in range(int(data.shape[0]))]
             if plan.layout is _plan.Layout.MULTILOAD else [data])
    cost: dict[str, float] = {}
    for part in parts:
        for name, (ops, nbytes) in _kernel_work(plan, int(part.shape[0]), int(part.shape[1]),
                                                q, part.element_size(), query_bytes).items():
            cost[f"{name} flops"] = cost.get(f"{name} flops", 0.0) + float(ops)
            cost[f"{name} bytes accessed"] = (cost.get(f"{name} bytes accessed", 0.0)
                                              + float(nbytes))
    flops = sum(v for k, v in cost.items() if k.endswith(" flops"))
    nbytes = sum(v for k, v in cost.items() if k.endswith(" bytes accessed"))
    cost.update({"flops": flops, "bytes accessed": nbytes})
    return {
        "mode": "lower",
        "flops": flops,
        "bytes_accessed": nbytes,
        "cost_keys": sorted(cost)[:16],
    }


# ---------------------------------------------------------------------------
# Candidate generation
# ---------------------------------------------------------------------------

_TILE_CANDIDATES = {
    "tile_q": (8, 16, 32, 64, 128, 256, 512),
    "tile_n": (128, 256, 512, 1024, 2048),
    "tile_v": (128, 256, 512, 1024),
    "tile_m": (128, 256, 512, 1024),
}
# Greedy axis order: the object axis dominates grid shape, then queries,
# then the in-kernel chunk axes.
_TILE_AXIS_ORDER = ("tile_n", "tile_q", "tile_v", "tile_m")


def _variant(kernel: str, knob: str, dim: int, value: Optional[int] = None) -> int:
    """The block shape `kernel` takes for `value` of `knob` (None: the
    default) over a dim of `dim` -- what the wrapper's pick_variant selects."""
    from repro_torch.kernels import common
    from repro_torch.kernels import ops as kops

    shapes = kops.VARIANTS[kernel][knob]
    preferred = value or max(max(shapes), common.TILE_ALIGN[knob])
    return common.pick_variant(dim, preferred, shapes, knob)


def tile_candidates(knob: str, dim: int, kernel: str, *, width: int = 1,
                    smem_budget: Optional[int] = SMEM_BUDGET_BYTES,
                    device: DeviceLike = None) -> list[int]:
    """Candidate values for one knob of `kernel` against its actual dim,
    deduplicated by the block shape each selects (the first value of each
    shape is kept), leaving out a shape whose shared memory at rows of
    `width` exceeds the budget (`smem_budget`; None = the device's own)."""
    from repro_torch.kernels import ops as kops

    budget = smem_budget_bytes(device) if smem_budget is None else int(smem_budget)
    seen, out = set(), []
    for cand in _TILE_CANDIDATES[knob]:
        shape = _variant(kernel, knob, dim, cand)
        if shape in seen:
            continue
        seen.add(shape)
        # the other knobs at their default (largest) shapes
        tiles = {k: max(v) for k, v in kops.VARIANTS[kernel].items()}
        smem = kops.variant_smem(kernel, {**tiles, knob: shape}, width)
        if smem is not None and smem > budget:
            continue
        out.append(cand)
    return out


def _path_kernel(model: "_engines.MatchModel", layout: SignatureLayout, fused: bool) -> str:
    """The kernel a plan of this engine and layout runs (the fused one when
    the plan carries it)."""
    if layout is SignatureLayout.PACKED:
        prefix = "packed_cosine" if model.engine is Engine.COSINE else "packed_tanimoto"
        return prefix + ("_topk" if fused else "_count")
    return {Engine.EQ: "match_count", Engine.RANGE: "range_count",
            Engine.MINSUM: "minsum_count", Engine.IP: "ip_count",
            Engine.TANIMOTO: "tanimoto_count", Engine.COSINE: "cosine_count"}[model.engine]


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _split_parts(data, part_rows: Sequence[int]) -> list:
    parts, off = [], 0
    for r in part_rows:
        parts.append(data[off:off + r])
        off += r
    if off != data.shape[0]:
        raise ValueError(
            f"part_rows {tuple(part_rows)} covers {off} rows but data has "
            f"{data.shape[0]}")
    return parts


def tune(engine: Engine | str | _engines.MatchModel, data, queries, k: int,
         max_count: Optional[int] = None, *,
         signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
         method: TopKMethod | str = TopKMethod.CPQ,
         part_rows: Optional[Sequence[int]] = None,
         router=None, routing: Routing | str = Routing.NONE,
         candidate_caps: Sequence[Optional[int]] = (),
         budget: int = 32, repeats: int = 3, warmup: int = 1,
         smem_budget: Optional[int] = SMEM_BUDGET_BYTES,
         cache: Optional[AutotuneCache] = None, save: bool = True,
         prepared: bool = False, route_queries=None,
         device: DeviceLike = None,
         ) -> TunedEntry:
    """Measure-and-pick the knob set for one (engine, layout, shape).

    `data` / `queries` are raw engine inputs (`MatchModel.example` form),
    prepared and packed here on `device` (None = the card) exactly as
    GenieIndex does it.  `prepared=True` instead takes `data` already in the
    stored layout (the full tensor; packed words / bytes for PACKED) and
    `queries` in the canonical stored layout, on their device -- the serving
    path, whose sealed segments cannot be un-packed; it requires an explicit
    `max_count` and, for routed PACKED tuning, `route_queries` (the canonical
    WIDE queries the router scores).  With `part_rows` the search runs
    part-structured and adds the layout axis (SEGMENTED vs MULTILOAD host
    loop -- both stream the same per-part tensors, so the choice is purely a
    merge-orchestration measurement) and, given `router` + `routing`, the
    nprobe axis.  `budget` caps measured candidates; the default-knob plan is
    always measured first as the baseline, and the returned entry falls back
    to default knobs whenever no candidate beats it (tuned can never
    regress).  A candidate whose block shape needs more shared memory than
    `smem_budget` (None = the device's own) is never measured, nor is one
    that selects the incumbent's shape again.

    The winning entry is put (and saved) into `cache` when given.
    """
    from repro_torch.kernels import ops as kops

    model = engine if isinstance(engine, _engines.MatchModel) \
        else _engines.get(engine)
    sig_layout = model.require_layout(signature_layout)
    method = TopKMethod(method)
    routing = Routing(routing)

    if prepared:
        if max_count is None:
            raise ValueError(
                "tune(prepared=True) needs an explicit max_count; the "
                "stored-layout tensor cannot derive the count bound")
        stored, q_stored, mc = data, queries, int(max_count)
        route_q = route_queries
    else:
        dev = resolve_device(device)
        wide = model.prepare_data(data, dev)
        mc = model.resolve_max_count(wide, max_count)
        stored = model.pack_data(wide) if sig_layout is SignatureLayout.PACKED \
            else wide
        q_stored = model.prepare_queries_for(queries, dev, sig_layout)
        route_q = (model.prepare_queries(queries, dev)
                   if sig_layout is SignatureLayout.PACKED else None)
    n, width = int(stored.shape[0]), int(stored.shape[1])
    n_q = int(_plan._first_query_tensor(q_stored).shape[0])
    dev = _query_device(q_stored)

    part_rows = tuple(int(r) for r in part_rows) if part_rows else None
    base_layout = _plan.Layout.SEGMENTED if part_rows else _plan.Layout.MONOLITHIC
    exec_data = _split_parts(stored, part_rows) if part_rows else stored

    knobs = model.tile_knobs(True, sig_layout)
    if sig_layout is SignatureLayout.PACKED:
        knobs = knobs | model.tile_knobs(True, sig_layout, fused=True)
    # the kernels see one part at a time: a part's rows are the tile_n dim
    n_dim = max(part_rows) if part_rows else n
    dims = {"tile_q": n_q, "tile_n": n_dim, "tile_v": width, "tile_m": width}

    state = {
        "tiles": {}, "fused": None, "candidate_cap": None,
        "layout": base_layout, "host_loop": False, "nprobe": None,
    }

    def make_plan(st):
        p = _plan.plan_search(
            model, k, mc,
            layout=st["layout"], part_rows=part_rows,
            method=method, candidate_cap=st["candidate_cap"],
            use_kernel=True, host_loop=st["host_loop"],
            signature_layout=sig_layout,
            routing=routing if st["layout"] is not _plan.Layout.MONOLITHIC
            else Routing.NONE,
            nprobe=st["nprobe"],
            tile_overrides=st["tiles"] or None,
        )
        if st["fused"] is False and p.fused_match is not None:
            p = dataclasses.replace(p, fused_match=None)
        return p

    def run(st):
        return measure_plan(make_plan(st), exec_data, q_stored,
                            router=router, route_queries=route_q,
                            repeats=repeats, warmup=warmup)

    trials = 0
    default_us = run(state)
    best, best_us = dict(state, tiles=dict(state["tiles"])), default_us

    def try_state(st):
        nonlocal trials, best, best_us
        if trials >= budget:
            return
        trials += 1
        # every trial is an interleaved head-to-head against the incumbent:
        # a solo sequential measurement drifts with the machine, so the
        # sweep would crown whichever candidate happened to run at a calm
        # moment.  Re-anchor the incumbent's clock from the same interleave
        # so stale timings never survive the sweep.
        inc_us, cand_us = compare_plans(
            make_plan(best), make_plan(st), exec_data, q_stored,
            router=router, route_queries=route_q, rounds=max(repeats, 2))
        best_us = inc_us
        if cand_us < inc_us:
            best, best_us = dict(st, tiles=dict(st["tiles"])), cand_us

    # axis 1: tile sizes, greedy per knob, one candidate per block shape of
    # the kernel the plan runs (a knob that kernel does not take, or a shape
    # the incumbent already has, is not measured)
    kernel = _path_kernel(model, sig_layout, make_plan(state).fused_match is not None)
    for knob in _TILE_AXIS_ORDER:
        if knob not in knobs or knob not in kops.VARIANTS[kernel]:
            continue
        incumbent = _variant(kernel, knob, dims[knob], best["tiles"].get(knob))
        for cand in tile_candidates(knob, dims[knob], kernel, width=width,
                                    smem_budget=smem_budget, device=dev):
            if _variant(kernel, knob, dims[knob], cand) == incumbent:
                continue
            tiles = dict(best["tiles"])
            tiles[knob] = cand
            try_state(dict(best, tiles=tiles))

    # axis 2: fused packed kernel off (on is the gated default)
    if sig_layout is SignatureLayout.PACKED \
            and make_plan(best).fused_match is not None:
        try_state(dict(best, tiles=dict(best["tiles"]), fused=False))

    # axis 3: candidate_cap
    for cap in candidate_caps:
        try_state(dict(best, tiles=dict(best["tiles"]),
                       candidate_cap=None if cap is None else int(cap)))

    # axis 4: part layout -- SEGMENTED vs MULTILOAD host loop stream the
    # same per-part tensors; only the merge orchestration differs
    if part_rows:
        try_state(dict(best, tiles=dict(best["tiles"]),
                       layout=_plan.Layout.MULTILOAD, host_loop=True))

    # axis 5: routing probe width
    if part_rows and router is not None and routing is not Routing.NONE:
        for cand in (1, 2, 4, 8, 16):
            if cand > len(part_rows):
                break
            try_state(dict(best, tiles=dict(best["tiles"]), nprobe=cand))

    # head-to-head: interleaved re-measure of winner vs default (sequential
    # timing on a warming machine favours whoever runs last); keep defaults
    # unless the winner still wins
    default_state = {"tiles": {}, "fused": None, "candidate_cap": None,
                     "layout": base_layout, "host_loop": False, "nprobe": None}
    if best != default_state:
        default_us, best_us = compare_plans(
            make_plan(default_state), make_plan(best), exec_data, q_stored,
            router=router, route_queries=route_q,
            rounds=max(repeats, 3))
    if best_us >= default_us:
        best = default_state
        best_us = default_us

    tuned_layout = None
    if part_rows:
        tuned_layout = ("multiload_host"
                        if best["layout"] is _plan.Layout.MULTILOAD
                        else "segmented")
    entry = TunedEntry(
        engine=model.engine.value,
        signature_layout=sig_layout.value,
        n_bucket=shape_bucket(n),
        w_bucket=shape_bucket(width),
        tile_overrides=_engines.canonical_tile_overrides(best["tiles"]),
        fused_match=best["fused"],
        layout=tuned_layout,
        candidate_cap=best["candidate_cap"],
        nprobe=best["nprobe"],
        measured_us=best_us,
        default_us=default_us,
        speedup=(default_us / best_us) if best_us > 0 else 1.0,
    )
    if cache is not None:
        cache.put(entry)
        if save:
            cache.save()
    return entry
