"""The autotuner (`repro_torch.core.autotune`) against the JAX package's
(`repro.core.autotune`), test for test after tests/test_autotune.py: the same
numpy inputs go through both packages, and tuned plans are a pure perf knob.

  * Parity -- a plan carrying tile overrides, a cached entry or a tuned
    layout returns the reference's ids / counts / threshold bit for bit
    (the engine x layout x method matrix at floor and huge tiles is in
    tests/test_torch_autotune_tiles.py).
  * Fallback -- a missing / corrupt / foreign-machine cache keeps the
    defaults; a cache file written by either package is refused by the
    other.
  * Keying -- tile_overrides are part of the QueryPlan's equality and hash
    and surface in describe(); every validation message is the reference's.
  * The kernel layer -- `pick_variant` maps a knob onto the block shapes a
    kernel was compiled in, the fused kernels' plain versions give the
    buffers of either tile, and `price_plan(mode="lower")` runs nothing.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import autotune as jautotune
from repro.core import engines as jengines
from repro.core import plan as jplan
from repro.core.types import Engine as JEngine
from repro_torch.core import GenieIndex, SegmentedIndex, autotune, engines
from repro_torch.core import plan as tplan
from repro_torch.core.types import Engine
from repro_torch.kernels import common
from repro_torch.kernels import ops as kops

CPU = torch.device("cpu")


def _case(engine: Engine, n=101, q=4, seed=0):
    model = engines.get(engine)
    raw, queries, mc = model.example(np.random.default_rng(seed), n, q)
    data = model.prepare_data(raw, CPU)
    return model, raw, data, queries, model.resolve_max_count(data, mc)


def _same(got, want, label=""):
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids)), label
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts)), label
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold)), label


def _entry(lib, **kw):
    base = dict(engine="eq", signature_layout="wide", n_bucket=128,
                w_bucket=64, tile_overrides=(("tile_n", 512),), speedup=1.4)
    base.update(kw)
    return lib.TunedEntry(**base)


# ---------------------------------------------------------------------------
# The module: names, fingerprint
# ---------------------------------------------------------------------------

def test_public_names_are_the_references():
    """Every public name of the reference but `setup_platform` (XLA flags:
    no counterpart, the docstring says why); SMEM_BUDGET_BYTES stands where
    VMEM_BUDGET_BYTES stood."""
    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, type(json))
                and getattr(v, "__module__", mod.__name__) == mod.__name__}
    want = public(jautotune) - {"setup_platform", "VMEM_BUDGET_BYTES"} | {"SMEM_BUDGET_BYTES"}
    assert want <= public(autotune)
    assert not hasattr(autotune, "setup_platform") and "setup_platform" in autotune.__doc__
    assert "synchronize" in autotune.__doc__ and "not CUDA events" in autotune.__doc__


def test_fingerprint_and_cache_device_rule():
    fp = autotune.hardware_fingerprint("cpu")
    assert fp["platform"] == "cpu" and fp["memory_bytes"] is None
    assert fp["torch"] == torch.__version__ and "jax" not in fp
    assert fp != jautotune.hardware_fingerprint()
    if not torch.cuda.is_available():          # device=None means the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            autotune.AutotuneCache()
    assert autotune.smem_budget_bytes("cpu") == autotune.CPU_SMEM_BUDGET_BYTES
    assert autotune.AutotuneCache(device="cpu").device == CPU


# ---------------------------------------------------------------------------
# Parity through the entry points
# ---------------------------------------------------------------------------

def test_segmented_tiles_and_layout_switch_parity():
    """Tile overrides ride the host part loop, and a tuned layout switch
    (SEGMENTED -> MULTILOAD host) returns the reference's result."""
    model, raw, data, queries, mc = _case(Engine.EQ, n=150)
    seg = SegmentedIndex(engine=Engine.EQ, max_count=mc, device="cpu")
    jseg = JSegmentedIndex(engine=JEngine.EQ, max_count=mc, use_kernel=False)
    for a, b in ((0, 40), (40, 41), (41, 150)):
        seg.add(raw[a:b])
        jseg.add(raw[a:b])
    base = jseg.search(queries, k=5)
    _same(seg.search(queries, k=5), base)
    _same(seg.search(queries, k=5, tile_overrides={"tile_n": 128}), base, "segmented tiled")
    cache = autotune.AutotuneCache(device="cpu")
    cache.put(_entry(autotune, n_bucket=autotune.shape_bucket(seg.n_objects),
                     w_bucket=autotune.shape_bucket(raw.shape[1]),
                     tile_overrides=(("tile_n", 128),), layout="multiload_host", speedup=1.3))
    calls = []
    orig = SegmentedIndex.search_multiload

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)
    SegmentedIndex.search_multiload = spy
    try:
        _same(seg.search(queries, k=5, autotune=cache), base, "tuned layout switch")
    finally:
        SegmentedIndex.search_multiload = orig
    assert calls == [1]


def test_genie_index_autotune_parity():
    """GenieIndex.search(autotune=cache) applies the cached tiles and still
    matches the reference exactly."""
    model, raw, data, queries, mc = _case(Engine.COSINE, n=140)
    idx = GenieIndex.build(Engine.COSINE, raw, max_count=mc, device="cpu")
    jidx = JGenieIndex.build(JEngine.COSINE, raw, max_count=mc, use_kernel=False)
    cache = autotune.AutotuneCache(device="cpu")
    cache.put(_entry(autotune, engine="cosine", n_bucket=autotune.shape_bucket(140),
                     w_bucket=autotune.shape_bucket(data.shape[1]),
                     tile_overrides=(("tile_n", 128), ("tile_q", 8)), speedup=1.2))
    _same(idx.search(queries, k=6, autotune=cache), jidx.search(queries, k=6))


def test_fused_plain_buffers_at_either_tile_equal_the_reference():
    """The fused kernels' plain versions give the buffers of the tile asked
    for, [Q, ceil(N / tile) * min(k, tile)], and after topk_from_candidates
    the reference's fused result, at tile_n 1024 and 2048."""
    from repro.kernels import ops as jops
    from repro_torch.core import cpq
    from repro_torch.kernels.packed_cosine import packed_cosine_topk_plain
    from repro_torch.kernels.packed_tanimoto import packed_tanimoto_topk_plain

    rng = np.random.default_rng(3)
    n, q, k = 2500, 3, 7
    cases = {
        "cosine": (packed_cosine_topk_plain, jops.packed_cosine_topk,
                   rng.integers(-2**31, 2**31 - 1, (n, 3)).astype(np.int32),
                   rng.integers(-2**31, 2**31 - 1, (q, 3)).astype(np.int32)),
        "tanimoto": (packed_tanimoto_topk_plain, jops.packed_tanimoto_topk,
                     rng.integers(0, 4, (n, 9)).astype(np.uint8),
                     rng.integers(0, 4, (q, 9)).astype(np.uint8)),
    }
    for name, (plain, jfused, d, s) in cases.items():
        jids, jcnts = jfused(d, s, k=k, interpret=True)
        want = jplan._fused_candidates_topk(lambda dd, qq, kk: (jids, jcnts), None, None, k)
        for tile in (1024, 2048):
            ids, cnts = plain(torch.from_numpy(d), torch.from_numpy(s), k, tile)
            assert ids.shape == (q, -(-n // tile) * min(k, tile))
            got = cpq.topk_from_candidates(ids, cnts, k)
            assert np.array_equal(got[0].numpy(), np.asarray(want[0])), (name, tile)
            assert np.array_equal(got[1].numpy(), np.asarray(want[1])), (name, tile)
        # the wrapper takes the tile its knob picks
        ids, _ = getattr(kops, f"packed_{name}_topk")(torch.from_numpy(d), torch.from_numpy(s),
                                                      k=k, tile_n=1024)
        assert ids.shape == (q, 3 * k)


# ---------------------------------------------------------------------------
# Plan keying + describe()
# ---------------------------------------------------------------------------

def test_tile_overrides_key_the_plan():
    """Plans differing only in tile_overrides are distinct -- and equal
    overrides (any spelling) are one key, with one bound match callable;
    describe() shows them as the reference does."""
    mk = lambda tiles: tplan.plan_search(  # noqa: E731
        Engine.EQ, 5, 16, part_rows=(64,), use_kernel=True, tile_overrides=tiles)
    a, b = mk(None), mk({"tile_n": 256})
    assert a != b and hash(a) != hash(b)
    c = mk([("tile_n", 256)])                 # pair-list spelling, same knobs
    assert b == c and hash(b) == hash(c) and b.match is c.match
    jb = jplan.plan_search(JEngine.EQ, 5, 16, part_rows=(64,), use_kernel=True,
                           tile_overrides={"tile_n": 256})
    assert b.describe()["tile_overrides"] == jb.describe()["tile_overrides"] == {"tile_n": 256}
    model, raw, data, queries, mc = _case(Engine.EQ, n=64)
    q_wide = model.prepare_queries(queries, CPU)
    p1 = tplan.plan_search(model, 5, mc, part_rows=(64,), use_kernel=True)
    p2 = tplan.plan_search(model, 5, mc, part_rows=(64,), use_kernel=True,
                           tile_overrides={"tile_n": 256})
    _same(tplan.execute(p2, data, q_wide), tplan.execute(p1, data, q_wide))
    # a knob the path does not take is dropped from the bound callable
    fused = tplan.plan_search(Engine.TANIMOTO, 5, 16, part_rows=(64,), signature_layout="packed",
                              tile_overrides={"tile_m": 256})
    assert fused.fused_match is engines.get(Engine.TANIMOTO).packed_fused_topk


# ---------------------------------------------------------------------------
# Validation: pick_variant + plan_search rejections
# ---------------------------------------------------------------------------

def test_pick_variant_validates_as_pick_tile_does():
    from repro.kernels.common import pick_tile

    for knob, align, bad in (("tile_n", 0, 256), ("tile_q", 8, 4)):
        with pytest.raises(ValueError) as ours:
            common.pick_variant(100, bad, (32, 128), knob, align=align)
        with pytest.raises(ValueError) as theirs:
            pick_tile(100, bad, align, knob=knob)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="alignment floor 128"):
        kops.match_count(torch.zeros((4, 3), dtype=torch.int32),
                         torch.zeros((2, 3), dtype=torch.int32), tile_n=64)


@pytest.mark.parametrize("size, preferred, want", [
    (1, 128, 32), (32, 128, 32), (33, 128, 128), (1024, 128, 128), (1024, 64, 32),
    (50, 64, 32), (1024, 4096, 128), (4, 8, 32), (1024, 8, 32), (129, 4096, 128)])
def test_pick_variant_on_its_own(size, preferred, want):
    """The largest shape <= preferred (else the smallest); below preferred,
    the smallest that covers the dim, as pick_tile clamps to it."""
    assert common.pick_variant(size, preferred, (128, 32), "tile_q") == want


def test_tile_candidates_dedupe_by_shape_and_prune_by_shared_memory():
    assert autotune.tile_candidates("tile_q", 1024, "match_count", device="cpu") == [8, 128]
    assert autotune.tile_candidates("tile_q", 5, "match_count", device="cpu") == [8]
    assert autotune.tile_candidates("tile_n", 10**6, "packed_cosine_topk", width=8,
                                    device="cpu") == [128, 2048]
    assert autotune.tile_candidates("tile_v", 238, "cosine_count", device="cpu") == [128]
    # the 2048-row tile at W = 8 asks for 218,368 bytes, the 1024-row one 152,832
    assert kops.variant_smem("packed_cosine_topk", {"tile_q": 64, "tile_n": 2048}, 8) == 218368
    assert autotune.tile_candidates("tile_n", 10**6, "packed_cosine_topk", width=8,
                                    smem_budget=200_000) == [128]
    assert autotune.tile_candidates("tile_q", 1024, "match_count",
                                    smem_budget=30_000) == [8]


def test_plan_search_rejects_bad_tiles_with_the_references_messages():
    cases = [
        (dict(tile_overrides={"tile_x": 8}), "unknown tile knob"),
        (dict(tile_overrides={"tile_n": 64}), "alignment floor"),
        (dict(use_kernel=False, tile_overrides={"tile_n": 128}), "use_kernel=False"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match) as ours:
            tplan.plan_search(Engine.EQ, 3, 16, **kw)
        with pytest.raises(ValueError) as theirs:
            jplan.plan_search(JEngine.EQ, 3, 16, **kw)
        assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]
    with pytest.raises(ValueError, match="raw match"):
        tplan.plan_search(lambda d, q: None, 3, 16, tile_overrides={"tile_n": 128})
    for lib in (engines, jengines):
        with pytest.raises(ValueError, match="duplicate"):
            lib.canonical_tile_overrides([("tile_n", 128), ("tile_n", 256)])
    assert engines.TILE_ALIGN == jengines.TILE_ALIGN
    for e in Engine:
        m, jm = engines.get(e), jengines.get(JEngine(e.value))
        assert (m.kernel_tile_knobs, m.packed_tile_knobs, m.packed_fused_tile_knobs) == (
            jm.kernel_tile_knobs, jm.packed_tile_knobs, jm.packed_fused_tile_knobs)


# ---------------------------------------------------------------------------
# Cache: round trip, fingerprint gate, the other package's file, corrupt file
# ---------------------------------------------------------------------------

def test_cache_roundtrip_and_fingerprint_gate(tmp_path):
    path = tmp_path / "autotune_torch.json"
    cache = autotune.AutotuneCache(path, device="cpu")
    cache.put(_entry(autotune))
    cache.save()
    reloaded = autotune.AutotuneCache(path, device="cpu")
    assert reloaded.entries == cache.entries
    assert reloaded.lookup("eq", "wide", n=100, width=60) == _entry(autotune)
    assert reloaded.lookup("eq", "wide", n=100) == _entry(autotune)   # width-agnostic
    assert reloaded.lookup("eq", "wide", n=5000) is None
    assert reloaded.lookup("eq", "wide", n=None) is None
    foreign = autotune.AutotuneCache(path, device="cpu")
    foreign.fingerprint = {"platform": "not-this-machine"}
    assert foreign.lookup("eq", "wide", n=100, width=60) is None
    # the rows read the same in both packages' TunedEntry
    jrows = {k: jautotune.TunedEntry.from_dict(v)
             for k, v in json.loads(path.read_text())["entries"].items()}
    assert {k: v.to_dict() for k, v in jrows.items()} == {
        k: v.to_dict() for k, v in cache.entries.items()}


def test_a_cache_of_the_other_package_keeps_the_defaults(tmp_path):
    """A file written by the reference never matches the port (its
    fingerprint carries "jax" and its platform), and the port's never
    matches the reference."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jcache = jautotune.AutotuneCache(jpath)
    jcache.put(_entry(jautotune))
    jcache.save()
    tcache = autotune.AutotuneCache(tpath, device="cpu")
    tcache.put(_entry(autotune))
    tcache.save()
    assert autotune.AutotuneCache(jpath, device="cpu").lookup("eq", "wide", 100, 60) is None
    assert jautotune.AutotuneCache(tpath).lookup("eq", "wide", 100, 60) is None
    assert autotune.AutotuneCache(tpath, device="cpu").lookup("eq", "wide", 100, 60) is not None
    assert jautotune.AutotuneCache(jpath).lookup("eq", "wide", 100, 60) is not None
    assert autotune.default_cache_path().name == "autotune_torch.json"
    assert jautotune.default_cache_path().name == "autotune.json"


def test_corrupt_cache_degrades_to_defaults(tmp_path):
    path = tmp_path / "autotune_torch.json"
    path.write_text("{not json")
    assert autotune.AutotuneCache(path, device="cpu").entries == {}
    path.write_text(json.dumps({"version": 99, "fingerprint": {}, "entries": {"x": {}}}))
    assert autotune.AutotuneCache(path, device="cpu").entries == {}   # version gate
    path.write_text(json.dumps({"version": 1, "fingerprint": {}, "entries": {
        "x": {"tile_overrides": {"tile_n": 3}}}}))
    cache = autotune.AutotuneCache(path, device="cpu")
    assert cache.entries == {} and cache.compatible()


def test_consult_resolves_specs(tmp_path, monkeypatch):
    kw = dict(engine="eq", signature_layout="wide", n=100, device="cpu")
    assert autotune.consult(None, **kw) is None
    assert autotune.consult(False, **kw) is None
    path = tmp_path / "c.json"
    cache = autotune.AutotuneCache(path, device="cpu")
    cache.put(_entry(autotune))
    cache.save()
    autotune.clear_resolved_caches()
    assert autotune.consult(str(path), width=60, **kw) == _entry(autotune)
    assert autotune.resolve_cache(str(path), "cpu") is autotune.resolve_cache(path, "cpu")
    # spec=True routes through GENIE_TORCH_AUTOTUNE_CACHE, not the reference's variable
    monkeypatch.setenv("GENIE_AUTOTUNE_CACHE", str(tmp_path / "elsewhere.json"))
    monkeypatch.setenv("GENIE_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_resolved_caches()
    assert autotune.consult(True, width=60, **kw) == _entry(autotune)
    autotune.clear_resolved_caches()


def test_plan_search_applies_cache_and_explicit_args_win():
    for lib, plan_lib, eng, kw in ((autotune, tplan, Engine.EQ, {"device": "cpu"}),
                                   (jautotune, jplan, JEngine.EQ, {})):
        cache = lib.AutotuneCache(**kw)
        cache.put(_entry(lib, tile_overrides=(("tile_n", 512),), candidate_cap=32))
        tuned = plan_lib.plan_search(eng, 3, 16, part_rows=(100,), use_kernel=True,
                                     autotune=cache, tune_width=60)
        assert dict(tuned.tile_overrides) == {"tile_n": 512}
        assert tuned.params.candidate_cap == 32
        explicit = plan_lib.plan_search(eng, 3, 16, part_rows=(100,), use_kernel=True,
                                        autotune=cache, tune_width=60, candidate_cap=48,
                                        tile_overrides={"tile_n": 256})
        assert dict(explicit.tile_overrides) == {"tile_n": 256}
        assert explicit.params.candidate_cap == 48
        # kernel-path knobs never leak onto the plain path
        plain = plan_lib.plan_search(eng, 3, 16, part_rows=(100,), use_kernel=False,
                                     autotune=cache, tune_width=60)
        assert plain.tile_overrides == () and plain.params.candidate_cap == 32
    # a tuned fused_match=False switches the fused PACKED kernel off
    cache = autotune.AutotuneCache(device="cpu")
    cache.put(_entry(autotune, engine="cosine", signature_layout="packed", fused_match=False))
    off = tplan.plan_search(Engine.COSINE, 3, 16, part_rows=(100,), signature_layout="packed",
                            autotune=cache, tune_width=60)
    assert off.fused_match is None and off.describe()["fused_match"] is False


# ---------------------------------------------------------------------------
# Pricing without running
# ---------------------------------------------------------------------------

def test_price_plan_lower_runs_nothing_and_host_loops_refuse():
    model, raw, data, queries, mc = _case(Engine.EQ, n=300, q=5)
    q_wide = model.prepare_queries(queries, CPU)
    plan = tplan.plan_search(model, 5, mc, part_rows=(300,))
    common.reset_launch_counts()
    got = autotune.price_plan(plan, data, q_wide, mode="lower")
    assert common.launch_counts() == {}
    q, n, m = 5, 300, 16
    assert got["flops"] == 2 * q * n * m + q * n          # match + histogram
    assert got["bytes_accessed"] == (n * m + q * m + q * n) * 4 + (q * n + q * (mc + 1)) * 4
    assert "match_count flops" in got["cost_keys"] and got["mode"] == "lower"
    scanned = tplan.plan_search(model, 5, mc, layout="multiload", n_parts=3, n_objects=300)
    chunks = tplan.pad_and_stack(scanned, data)
    assert autotune.price_plan(scanned, chunks, q_wide, mode="lower")["flops"] == got["flops"]
    segmented = tplan.plan_search(model, 5, mc, layout="segmented", part_rows=(100, 200))
    jsegmented = jplan.plan_search(JEngine.EQ, 5, mc, layout="segmented", part_rows=(100, 200))
    with pytest.raises(ValueError) as ours:
        autotune.price_plan(segmented, [data[:100], data[100:]], q_wide, mode="lower")
    with pytest.raises(ValueError) as theirs:
        jautotune.price_plan(jsegmented, None, None, mode="lower")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mode must be"):
        autotune.price_plan(plan, data, q_wide, mode="guess")
    assert autotune.price_plan(plan, data, q_wide, repeats=1)["p50_us"] > 0
    packed = tplan.plan_search(Engine.COSINE, 7, 64, part_rows=(3000,), signature_layout="packed")
    words = torch.zeros((3000, 2), dtype=torch.int32)
    qw = torch.zeros((4, 2), dtype=torch.int32)
    got = autotune.price_plan(packed, words, qw, mode="lower")
    assert got["flops"] == 3 * 4 * 3000 * 2
    assert got["bytes_accessed"] == (3000 * 2 + 4 * 2) * 4 + 2 * 4 * (2 * 7) * 4


# ---------------------------------------------------------------------------
# tune() end to end (tiny budget) + RetrievalService.tune
# ---------------------------------------------------------------------------

def test_tune_end_to_end_parity_and_cache():
    """A real (tiny-budget) tuning run: the entry lands in the cache, keys
    the shape correctly, and searching through it equals the reference."""
    model, raw, data, queries, mc = _case(Engine.EQ, n=256, q=8)
    cache = autotune.AutotuneCache(device="cpu")
    entry = autotune.tune(model, raw, queries, 5, mc, budget=2, repeats=1, cache=cache,
                          save=False, device="cpu", part_rows=(100, 156))
    assert entry.key() in cache.entries
    assert entry.n_bucket == autotune.shape_bucket(256) == 256
    assert entry.speedup >= 1.0          # tuned never records a regression
    assert entry.layout in ("segmented", "multiload_host")
    idx = GenieIndex.build(Engine.EQ, raw, max_count=mc, device="cpu")
    jidx = JGenieIndex.build(JEngine.EQ, raw, max_count=mc, use_kernel=False)
    _same(idx.search(queries, k=5, autotune=cache), jidx.search(queries, k=5))


def test_tune_prepared_requires_max_count():
    model, raw, data, queries, mc = _case(Engine.EQ, n=64)
    with pytest.raises(ValueError, match="max_count"):
        autotune.tune(model, data, model.prepare_queries(queries, CPU), 3, None, prepared=True)


def test_service_tune_smoke():
    """RetrievalService.tune wires the serving corpus into the tuner and
    installs the winning cache, on the service's device; results stay the
    reference's."""
    from repro.serve.retrieval import RetrievalService as JRetrievalService
    from repro_torch.core.lsh import e2lsh
    from repro_torch.serve import RetrievalService

    rng = np.random.default_rng(11)
    pts = rng.standard_normal((150, 16)).astype(np.float32)
    q = pts[40:45] + 0.01
    jsvc = JRetrievalService(embed_fn=np.asarray, m_override=32)
    jsvc.add(list(range(150)), embeddings=pts)
    jp = jsvc._params
    params = e2lsh.params_from_numpy(np.asarray(jp.a), np.asarray(jp.b), np.asarray(jp.seeds),
                                     jp.w, jp.p, jp.n_buckets, device="cpu")
    svc = RetrievalService(m_override=32, device="cpu", params=params)
    svc.add(list(range(150)), embeddings=pts)
    base, _ = jsvc.search(None, k=4, embeddings=q)
    untuned, _ = svc.search(None, k=4, embeddings=q)
    entry = svc.tune(None, k=4, embeddings=q, budget=2, repeats=1, save=False)
    assert isinstance(entry, autotune.TunedEntry) and entry.speedup >= 1.0
    assert isinstance(svc.autotune, autotune.AutotuneCache) and svc.autotune.device == CPU
    tuned, _ = svc.search(None, k=4, embeddings=q)
    assert torch.equal(tuned.ids, untuned.ids) and torch.equal(tuned.counts, untuned.counts)
    # the float projection may move a point across a bucket boundary
    # (tests/test_torch_lsh.py); where the signatures agree, so do the results
    if np.array_equal(torch.cat([s.data for s in svc._index.segments]).numpy(),
                      np.concatenate([np.asarray(s.data) for s in jsvc._index.segments])):
        _same(tuned, base)


def test_shared_memory_formulas_are_the_sources():
    """variant_smem mirrors what the launchers ask for: the fused kernel's
    constants (fused_topk.cuh) and its one-/two-byte shapes (packed_cosine.cu,
    packed_tanimoto.cu), and the equality tile's staged rows (eq_tile.cuh)."""
    import re

    from repro_torch.kernels import build

    fused = (build.CSRC_DIR / "fused_topk.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (K_\w+|MAX_SMEM) = (\d+);", fused)}
    assert (common.FUSED_THREADS, common.FUSED_RQ, common.FUSED_RN, common.FUSED_MAX_SMEM) == (
        const["K_THREADS"], const["K_RQ"], const["K_RN"], const["MAX_SMEM"])
    assert (const["K_TN"], const["K_TN_NARROW"]) == (2048, 1024)
    for src, u8 in (("packed_cosine.cu", "CosU8"), ("packed_tanimoto.cu", "CountU8")):
        text = (build.CSRC_DIR / src).read_text()
        assert f"using {u8} = Fused<uint8_t, 64, {common.FUSED_KW}>;" in text
        assert f"using {u8}Narrow = Fused<uint8_t, 64, 16, K_TN_NARROW>;" in text
    tile = (build.CSRC_DIR / "eq_tile.cuh").read_text()
    eq = tile[tile.index("namespace eq {"):]
    assert "using Wide = Shape<16, 8, 2>;" in eq and "using Narrow = Shape<8, 4, 4>;" in eq
    assert f"constexpr int LDI = KS + 1;" in eq and common.EQ_TILE_LDI == 33
    assert "static constexpr int RN = 4;" in eq and common.EQ_TILE_N == 32 * 4
    assert kops.variant_smem("match_count", {"tile_q": 32, "tile_n": 128}, 238) == 160 * 33 * 4
    # at W = 16 the bins of the 2048-row two-byte tile go to device scratch
    assert kops.variant_smem("packed_cosine_topk", {"tile_n": 2048}, 16) == (
        32 * 2048 * 2 + (512 * 17 + 32 * 16) * 4)
