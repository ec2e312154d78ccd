"""MatchModel registry: one descriptor per match-count engine.

GENIE's central claim is *genericity* -- one inverted-index machinery serving
many data types and similarity measures (paper section II).  This module makes
that claim structural: every engine is a single `MatchModel` descriptor
bundling

  * the reference match function (core/match.py -- the semantics oracle),
  * the CUDA kernel wrapper (kernels/ops.py -- the hot path on the card),
  * data and query canonicalisation (so every engine exposes the same
    ``fn(data, queries) -> counts[Q, N]`` signature),
  * index statistics and the count-domain bound,
  * the count-dtype policy (Bitmap-Counter bit-bounding, paper III-C),
  * the padding fill (a value that can never out-score real rows).

GenieIndex, SegmentedIndex and the planner all resolve engines through
`get()` -- there is exactly one dispatch point in the system.

All six engines of the JAX package's registry are here, in its order: EQ,
RANGE, MINSUM, IP, TANIMOTO with its PACKED format (uint8 bucket ids,
core/packing.py) and COSINE with its PACKED format (32 signs per int32
word).  Each descriptor also names the tile knobs its kernel path takes (the
reference's sets, which the autotuner in core/autotune.py searches); the
kernel wrappers map a knob's value onto the block shapes the kernel was
compiled in (kernels/ops.py VARIANTS).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import match as _match
from repro_torch.core import packing as _packing
from repro_torch.core.types import Engine, IndexStats, SignatureLayout
from repro_torch.device import int64_sum, tensor_from
from repro_torch.kernels.common import TILE_ALIGN


def canonical_tile_overrides(tile_overrides) -> tuple[tuple[str, int], ...]:
    """Normalise a mapping / pair-sequence of tile knobs to the sorted tuple
    form QueryPlan hashes on, validating names and alignment floors
    (TILE_ALIGN, the reference's: tile_q 8, tile_n / tile_v / tile_m 128)."""
    if tile_overrides is None:
        return ()
    items = (tile_overrides.items() if hasattr(tile_overrides, "items")
             else tile_overrides)
    out = []
    for name, value in items:
        name = str(name)
        if name not in TILE_ALIGN:
            raise ValueError(
                f"unknown tile knob {name!r}; known knobs: "
                f"{sorted(TILE_ALIGN)}"
            )
        value = int(value)
        if value < TILE_ALIGN[name]:
            raise ValueError(
                f"{name}={value} is below the alignment floor "
                f"{TILE_ALIGN[name]} (the reference's min-tile width); tuned "
                f"tiles must be >= the floor"
            )
        out.append((name, value))
    if len({n for n, _ in out}) != len(out):
        raise ValueError(f"duplicate tile knob in {tile_overrides!r}")
    return tuple(sorted(out))


# Tile-bound match callables, memoised so two plans with equal (model, base,
# overrides) share ONE callable identity: QueryPlan compares and hashes its
# match / fused_match fields, so equal tuned plans stay equal.
_TILED_FN_CACHE: dict = {}


def _as_int32(x: Any, device: torch.device) -> torch.Tensor:
    """Anything array-like -> contiguous int32 tensor on `device`; a tensor
    already there is not copied through the host."""
    return tensor_from(x).to(device=device, dtype=torch.int32).contiguous()


# what jnp.asarray makes of 64-bit inputs with 64-bit types off (the JAX
# package's default): the caller's dtype is kept, at 32 bits
_NARROW_64 = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.complex128: torch.complex64}


def _keep_dtype(x: Any, device: torch.device) -> torch.Tensor:
    """Anything array-like -> contiguous tensor on `device` in the caller's
    dtype, 64-bit types narrowed to 32 bits as the reference's `jnp.asarray`
    narrows them."""
    t = tensor_from(x)
    return t.to(device=device, dtype=_NARROW_64.get(t.dtype, t.dtype)).contiguous()


@dataclasses.dataclass(frozen=True)
class MatchModel:
    """Descriptor for one match-count engine (paper Definition 2.1).

    The canonical match signature is ``fn(data, queries) -> counts [Q, N]``
    where `queries` is this engine's canonical query form (produced by
    `prepare_queries`).  Both `reference` and `kernel` use it, so segmented
    search and serving are engine-agnostic.
    """

    engine: Engine
    description: str
    # raw user data, device -> device-resident index tensor (canonical form)
    prepare_data: Callable[[Any, torch.device], torch.Tensor]
    # raw queries, device -> canonical queries on the device
    prepare_queries: Callable[[Any, torch.device], Any]
    # plain PyTorch reference semantics (core/match.py), canonical signature
    reference: Callable[[torch.Tensor, Any], torch.Tensor]
    # CUDA kernel wrapper (kernels/ops.py), canonical signature; imports the
    # kernel layer lazily
    kernel: Callable[[torch.Tensor, Any], torch.Tensor]
    # index statistics: postings count for this data layout
    postings_count: Callable[[torch.Tensor], int]
    # default count-domain bound, or None when the caller must supply one
    default_max_count: Callable[[torch.Tensor], Optional[int]]
    # padded-row fill: padded rows must never beat real rows
    pad_value: Any = -1
    # seeded conformance data: (np rng, n, q) -> (raw_data, raw_queries,
    # max_count | None)
    example: Optional[Callable[[Any, int, int], tuple]] = None

    # -- PACKED signature layout (core/packing.py) --------------------------
    # All None/unset => the engine is WIDE-only and PACKED plans are rejected.
    # pack_data / pack_queries transform *prepared* (canonical WIDE) tensors
    # once at index-seal / query-canonicalisation time; packed_reference and
    # packed_kernel keep the canonical ``fn(data, queries) -> counts [Q, N]``
    # signature on the packed tensors, with counts bit-for-bit equal to WIDE.
    pack_data: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    pack_queries: Optional[Callable[[Any], Any]] = None
    packed_reference: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None
    packed_kernel: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None
    # fused match -> count -> per-tile local top-k on packed tensors:
    # fn(data, queries, k) -> (ids, counts) candidate buffers [Q, n_tiles*kc]
    # in per-tile (count desc, id asc) order, pads id -1 / count -1
    packed_fused_topk: Optional[Callable[[torch.Tensor, Any, int], tuple]] = None
    # padded-row fill in the packed domain (same never-out-scores contract
    # as pad_value; pad rows are id-masked upstream regardless)
    packed_pad_value: Any = None
    # packed footprint in bytes, computed from the WIDE prepared tensor
    packed_bytes: Optional[Callable[[torch.Tensor], int]] = None

    # -- tile knobs (core/autotune.py) --------------------------------------
    # The tile kwargs each kernel wrapper accepts (kernels/ops.py): the
    # autotuner's searchable axes for this engine.  Empty => the path takes
    # no tile overrides (reference fns never do).
    kernel_tile_knobs: frozenset = frozenset()
    packed_tile_knobs: frozenset = frozenset()
    packed_fused_tile_knobs: frozenset = frozenset()

    @property
    def supports_packed(self) -> bool:
        return self.pack_data is not None

    def require_layout(self, layout: SignatureLayout | str) -> SignatureLayout:
        layout = SignatureLayout(layout)
        if layout is SignatureLayout.PACKED and not self.supports_packed:
            raise ValueError(
                f"engine {self.engine.value!r} has no packed signature format; "
                f"use SignatureLayout.WIDE"
            )
        return layout

    def pad_value_for(self, layout: SignatureLayout | str) -> Any:
        if self.require_layout(layout) is SignatureLayout.PACKED:
            return self.packed_pad_value
        return self.pad_value

    def tile_knobs(
        self,
        use_kernel: bool,
        signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
        fused: bool = False,
    ) -> frozenset:
        """The tile knob names this engine's dispatch path accepts."""
        if not use_kernel:
            return frozenset()
        if self.require_layout(signature_layout) is SignatureLayout.PACKED:
            return (self.packed_fused_tile_knobs if fused
                    else self.packed_tile_knobs)
        return self.kernel_tile_knobs

    def _tiled(self, base: Callable, overrides: tuple, knobs: frozenset,
               tag: str) -> Callable:
        """Memoised wrapper binding the tile kwargs `base` accepts.  Knobs the
        path does not take (e.g. tile_m on a fused kernel that streams the
        signature axis itself) are dropped, so one tuned entry can drive both
        the count and the fused dispatchers."""
        kw = {n: v for n, v in overrides if n in knobs}
        if not kw:
            return base
        key = (tag, self, base, tuple(sorted(kw.items())))
        fn = _TILED_FN_CACHE.get(key)
        if fn is None:
            if tag == "fused":
                def fn(data, queries, k, _base=base, _kw=kw):
                    return _base(data, queries, k, **_kw)
            else:
                def fn(data, queries, _base=base, _kw=kw):
                    return _base(data, queries, **_kw)
            _TILED_FN_CACHE[key] = fn
        return fn

    # -- dispatch -----------------------------------------------------------
    def match_fn(
        self,
        use_kernel: bool,
        signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
        tile_overrides: tuple = (),
    ) -> Callable[[torch.Tensor, Any], torch.Tensor]:
        """The canonical match callable for this engine (kernel or reference),
        operating on tensors in the given signature layout.  `tile_overrides`
        (canonical ``((knob, value), ...)`` pairs, see
        `canonical_tile_overrides`) bind kernel tile kwargs; the returned
        callable is memoised per override set so equal plans share one
        identity."""
        layout = self.require_layout(signature_layout)
        if layout is SignatureLayout.PACKED:
            base = self.packed_kernel if use_kernel else self.packed_reference
        else:
            base = self.kernel if use_kernel else self.reference
        if not tile_overrides or not use_kernel:
            return base
        return self._tiled(base, tile_overrides,
                           self.tile_knobs(use_kernel, layout), "match")

    def fused_topk_fn(
        self,
        tile_overrides: tuple = (),
    ) -> Optional[Callable[[torch.Tensor, Any, int], tuple]]:
        """The fused packed match->count->local-top-k callable (None when the
        engine has none), with tile overrides bound (same memoisation
        contract as match_fn)."""
        if self.packed_fused_topk is None or not tile_overrides:
            return self.packed_fused_topk
        return self._tiled(self.packed_fused_topk, tile_overrides,
                           self.packed_fused_tile_knobs, "fused")

    def prepare_queries_for(
        self, queries: Any, device: torch.device,
        signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
    ) -> Any:
        """Raw queries -> canonical queries on `device` in the given layout
        (canonicalise WIDE first, then pack)."""
        q = self.prepare_queries(queries, device)
        if self.require_layout(signature_layout) is SignatureLayout.PACKED:
            q = self.pack_queries(q)
        return q

    def match_counts(self, data: torch.Tensor, queries: Any, use_kernel: bool,
                     signature_layout: SignatureLayout | str = SignatureLayout.WIDE) -> torch.Tensor:
        """counts int32 [Q, N]; `queries` may be raw (canonicalised here, onto
        the data's device) and `data` must already be in `signature_layout`."""
        return self.match_fn(use_kernel, signature_layout)(
            data, self.prepare_queries_for(queries, data.device, signature_layout))

    # -- build-time policy --------------------------------------------------
    def build_stats(self, data: torch.Tensor) -> IndexStats:
        """Index statistics from the *prepared WIDE* tensor (postings, count
        bounds and the packed footprint all read the logical layout -- call
        this before pack_data, never on the packed tensor)."""
        wide_bytes = int(data.numel()) * data.element_size()
        return IndexStats(
            n_objects=int(data.shape[0]),
            n_lists=int(data.shape[1]),
            total_postings=int(self.postings_count(data)),
            bytes_device=wide_bytes,
            bytes_signatures_wide=wide_bytes,
            bytes_signatures_packed=(
                int(self.packed_bytes(data)) if self.packed_bytes else 0
            ),
            extra={"engine": self.engine.value},
        )

    def resolve_max_count(self, data: torch.Tensor, max_count: Optional[int]) -> int:
        if max_count is not None:
            return int(max_count)
        derived = self.default_max_count(data)
        if derived is None:
            raise ValueError(
                f"engine {self.engine.value!r} has no derivable count bound; "
                f"pass max_count explicitly"
            )
        return int(derived)

    def count_dtype(self, max_count: int) -> torch.dtype:
        """Bitmap-Counter policy: narrowest lossless count dtype (III-C)."""
        return _match.as_count_dtype(torch.zeros((), dtype=torch.int32), max_count).dtype

    def as_count_dtype(self, counts: torch.Tensor, max_count: int) -> torch.Tensor:
        return _match.as_count_dtype(counts, max_count)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[Engine, MatchModel] = {}


def register(model: MatchModel) -> MatchModel:
    """Register (or replace) the descriptor for `model.engine`."""
    _REGISTRY[model.engine] = model
    return model


def get(engine: Engine | str | MatchModel) -> MatchModel:
    """Resolve an Engine, its string value, or a MatchModel to a descriptor."""
    if isinstance(model := engine, MatchModel):
        return model
    eng = Engine(engine)
    try:
        return _REGISTRY[eng]
    except KeyError:
        raise KeyError(
            f"no MatchModel registered for engine {eng.value!r}; "
            f"known: {sorted(m.value for m in _REGISTRY)}"
        ) from None


def available() -> tuple[Engine, ...]:
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in engines (paper sections IV-V)
# ---------------------------------------------------------------------------

def _kernel_eq(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.match_count(data, queries, **tiles)


def _kernel_range(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    lo, hi = queries
    return kops.range_count(data, lo, hi, **tiles)


def _kernel_minsum(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.minsum_count(data, queries, **tiles)


def _kernel_ip(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.ip_count(data, queries, **tiles)


def _kernel_tanimoto(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.tanimoto_count(data, queries, **tiles)


def _kernel_packed_tanimoto(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.packed_tanimoto_count(data, queries, **tiles)


def _kernel_packed_tanimoto_topk(data, queries, k, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.packed_tanimoto_topk(data, queries, k=k, **tiles)


def _kernel_cosine(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.cosine_count(data, queries, **tiles)


def _kernel_packed_cosine(data, queries, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.packed_cosine_count(data, queries, **tiles)


def _kernel_packed_cosine_topk(data, queries, k, **tiles):
    from repro_torch.kernels import ops as kops

    return kops.packed_cosine_topk(data, queries, k=k, **tiles)


def _int_total(a: torch.Tensor) -> int:
    """Sum of the entries, each truncated to an integer as the reference's
    int32 cast truncates it, in int64 (the reference sums in int32); integer
    data is summed as it is, without an int32 copy, a block of rows at a
    time."""
    if a.is_floating_point():
        a = a.to(torch.int32)
    return int(int64_sum(a))


def _sign_quantize(x: Any, device: torch.device) -> torch.Tensor:
    """Raw vectors -> {-1, +1} int8 on `device` (floats by sign; {0,1} bits
    map to -1/+1)."""
    t = tensor_from(x).to(device)
    return torch.where(t > 0, 1, -1).to(torch.int8).contiguous()


register(MatchModel(
    engine=Engine.EQ,
    description="signature equality compare over LSH signatures int32 [N, m]",
    prepare_data=_as_int32,
    prepare_queries=_as_int32,
    reference=_match.match_eq,
    kernel=_kernel_eq,
    postings_count=lambda a: int(a.shape[0]) * int(a.shape[1]),
    default_max_count=lambda a: int(a.shape[1]),          # m hash functions
    pad_value=-1,                                          # never equals a sig
    example=lambda rng, n, q: (rng.integers(0, 8, (n, 16)).astype(np.int32),
                               rng.integers(0, 8, (q, 16)).astype(np.int32), None),
    kernel_tile_knobs=frozenset({"tile_q", "tile_n"}),
))

register(MatchModel(
    engine=Engine.RANGE,
    description="per-attribute interval predicate over discretized tuples int32 [N, d]",
    prepare_data=_as_int32,
    # queries are a (lo, hi) pair of int32 [Q, d]
    prepare_queries=lambda q, device: (_as_int32(q[0], device), _as_int32(q[1], device)),
    reference=lambda d, q: _match.match_range(d, q[0], q[1]),
    kernel=_kernel_range,
    postings_count=lambda a: int(a.numel()),
    default_max_count=lambda a: int(a.shape[1]),          # #attributes
    pad_value=int(np.iinfo(np.int32).min),                # below any query lo
    example=lambda rng, n, q: (
        rng.integers(0, 10, (n, 6)).astype(np.int32),
        (lambda lo: (lo, lo + 3))(rng.integers(0, 6, (q, 6)).astype(np.int32)),
        None),
    kernel_tile_knobs=frozenset({"tile_q", "tile_n"}),
))

register(MatchModel(
    engine=Engine.MINSUM,
    description="multiset intersection sum_v min(c_data, c_query) over count vectors [N, V]",
    prepare_data=_as_int32,
    prepare_queries=_as_int32,
    reference=_match.match_minsum,
    kernel=_kernel_minsum,
    postings_count=lambda a: _int_total(a),
    default_max_count=lambda a: None,                     # caller supplies bound
    pad_value=-1,                                          # min(-1, q) sums < 0
    example=lambda rng, n, q: (rng.integers(0, 4, (n, 24)).astype(np.int32),
                               rng.integers(0, 4, (q, 24)).astype(np.int32), 96),
    kernel_tile_knobs=frozenset({"tile_q", "tile_n", "tile_v"}),
))

register(MatchModel(
    engine=Engine.IP,
    description="binary inner product over word vectors [N, V]",
    prepare_data=_keep_dtype,                              # keep caller dtype
    prepare_queries=_keep_dtype,
    reference=_match.match_ip,
    kernel=_kernel_ip,                                     # casts to int8 per call
    postings_count=lambda a: _int_total(a),
    default_max_count=lambda a: None,                     # caller supplies bound
    pad_value=0,                                           # zero dot product
    example=lambda rng, n, q: (rng.integers(0, 2, (n, 32)).astype(np.int32),
                               rng.integers(0, 2, (q, 32)).astype(np.int32), 32),
    kernel_tile_knobs=frozenset({"tile_q", "tile_n", "tile_v"}),
))

register(MatchModel(
    engine=Engine.TANIMOTO,
    description="minhash collision count over set sketches int32 [N, m] (Jaccard MLE c/m)",
    prepare_data=_as_int32,
    prepare_queries=_as_int32,
    reference=_match.match_tanimoto,
    kernel=_kernel_tanimoto,
    postings_count=lambda a: int(a.shape[0]) * int(a.shape[1]),
    default_max_count=lambda a: int(a.shape[1]),          # m minhash functions
    pad_value=-1,                                          # outside bucket range
    example=lambda rng, n, q: (rng.integers(0, 64, (n, 20)).astype(np.int32),
                               rng.integers(0, 64, (q, 20)).astype(np.int32), None),
    # PACKED: uint8 bucket ids (rehash domain <= 253; 254/255 pad sentinels)
    pack_data=_packing.pack_buckets,
    pack_queries=_packing.pack_buckets,
    packed_reference=_packing.packed_tanimoto_match,
    packed_kernel=_kernel_packed_tanimoto,
    packed_fused_topk=_kernel_packed_tanimoto_topk,
    packed_pad_value=_packing.PACKED_BUCKET_PAD_DATA,      # never collides
    packed_bytes=_packing.packed_bytes_tanimoto,
    kernel_tile_knobs=frozenset({"tile_q", "tile_n", "tile_m"}),
    packed_tile_knobs=frozenset({"tile_q", "tile_n", "tile_m"}),
    # the fused kernel streams the signature axis itself: no tile_m
    packed_fused_tile_knobs=frozenset({"tile_q", "tile_n"}),
))

register(MatchModel(
    engine=Engine.COSINE,
    description="sign-agreement count of sign-quantized vectors {-1,+1} int8 [N, V]",
    prepare_data=_sign_quantize,
    prepare_queries=_sign_quantize,
    reference=_match.match_cosine,
    kernel=_kernel_cosine,
    postings_count=lambda a: int(a.numel()),               # every sign is a posting
    default_max_count=lambda a: int(a.shape[1]),          # V sign agreements max
    pad_value=0,                                           # dot-neutral; id-masked
    example=lambda rng, n, q: (rng.standard_normal((n, 32)).astype(np.float32),
                               rng.standard_normal((q, 32)).astype(np.float32), None),
    # PACKED: 32 signs per int32 word, matched by XOR+popcount; query tail
    # bits 1 vs data tail bits 0 keep counts exact without knowing V
    pack_data=_packing.pack_signs_data,
    pack_queries=_packing.pack_signs_queries,
    packed_reference=_packing.packed_cosine_match,
    packed_kernel=_kernel_packed_cosine,
    packed_fused_topk=_kernel_packed_cosine_topk,
    packed_pad_value=0,                                    # all-zero words; id-masked
    packed_bytes=_packing.packed_bytes_cosine,
    kernel_tile_knobs=frozenset({"tile_q", "tile_n", "tile_v"}),
    # packed words are streamed by the kernels: only the [Q, N] tiles tune
    packed_tile_knobs=frozenset({"tile_q", "tile_n"}),
    packed_fused_tile_knobs=frozenset({"tile_q", "tile_n"}),
))
