"""Tiled plans against the reference's tiled plans (tests/test_autotune.py's
parity matrix, through both packages): every engine x CPQ / SPQ / SORT, WIDE
and PACKED (fused top-k included), at the knobs' alignment floors and at
oversized knobs.  Tile knobs pick block shapes, never the math, so ids,
counts and thresholds are the reference's bit for bit.  The reference runs
its Pallas kernels in interpret mode; the port its plain versions on the CPU,
after the same validation and shape picks as on the card."""
import numpy as np
import pytest
import torch

from repro.core import engines as jengines
from repro.core import plan as jplan
from repro.core.types import Engine as JEngine, TopKMethod as JMethod
from repro_torch.core import engines
from repro_torch.core import plan as tplan
from repro_torch.core.types import Engine, SignatureLayout, TopKMethod

CPU = torch.device("cpu")
ALL_ENGINES = sorted(engines.available(), key=lambda e: e.value)
PACKED_ENGINES = [e for e in ALL_ENGINES if engines.get(e).supports_packed]
ALL_METHODS = [TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT]
# every knob at its alignment floor, and oversized knobs (the reference's)
FLOOR_TILES = {"tile_q": 8, "tile_n": 128, "tile_v": 128, "tile_m": 128}
HUGE_TILES = {"tile_q": 4096, "tile_n": 65536, "tile_v": 8192, "tile_m": 8192}


def _inputs(engine: Engine, n: int, q: int = 4, seed: int = 0):
    raw, queries, mc = engines.get(engine).example(np.random.default_rng(seed), n, q)
    return raw, queries, mc


def _same(got, want, label):
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids)), label
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts)), label
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold)), label


@pytest.mark.parametrize("engine", ALL_ENGINES)
@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("tiles", [FLOOR_TILES, HUGE_TILES], ids=["floor", "huge"])
def test_tiled_plan_parity_wide(engine, method, tiles):
    """Kernel plans with floor / huge tile overrides equal the reference's
    tiled plan on the WIDE layout."""
    k = 9
    raw, queries, mc = _inputs(engine, 101)
    model, jmodel = engines.get(engine), jengines.get(JEngine(engine.value))
    data, jdata = model.prepare_data(raw, CPU), jmodel.prepare_data(raw)
    mc = model.resolve_max_count(data, mc)
    plan = tplan.plan_search(model, k, mc, part_rows=(101,), method=method, use_kernel=True,
                             tile_overrides=tiles)
    jp = jplan.plan_search(jmodel, k, mc, part_rows=(101,), method=JMethod(method.value),
                           use_kernel=True, tile_overrides=tiles)
    assert dict(plan.tile_overrides) == dict(jp.tile_overrides)
    assert plan.describe() == jp.describe()
    got = tplan.execute(plan, data, model.prepare_queries(queries, CPU))
    want = jplan.execute(jp, jdata, jmodel.prepare_queries(queries))
    _same(got, want, f"{engine.value} {method.value} {tiles}")


@pytest.mark.parametrize("engine", PACKED_ENGINES)
@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("tiles", [FLOOR_TILES, HUGE_TILES], ids=["floor", "huge"])
def test_tiled_plan_parity_packed(engine, method, tiles):
    """PACKED plans (the fused kernel path, whose tile_n picks its 1024- or
    2048-row tile) equal the reference's tiled plan too; 1300 rows are two
    tiles of the narrow tile and one of the default."""
    k = 7
    raw, queries, mc = _inputs(engine, 1300)
    model, jmodel = engines.get(engine), jengines.get(JEngine(engine.value))
    data, jdata = model.prepare_data(raw, CPU), jmodel.prepare_data(raw)
    mc = model.resolve_max_count(data, mc)
    plan = tplan.plan_search(model, k, mc, part_rows=(1300,), method=method,
                             signature_layout=SignatureLayout.PACKED, tile_overrides=tiles)
    jp = jplan.plan_search(jmodel, k, mc, part_rows=(1300,), method=JMethod(method.value),
                           use_kernel=True, signature_layout="packed", tile_overrides=tiles)
    assert plan.fused_match is not None and jp.fused_match is not None
    assert plan.describe() == jp.describe()
    got = tplan.execute(plan, model.pack_data(data),
                        model.prepare_queries_for(queries, CPU, SignatureLayout.PACKED))
    want = jplan.execute(jp, jmodel.pack_data(jdata),
                         jmodel.prepare_queries_for(queries, "packed"))
    _same(got, want, f"{engine.value} {method.value} packed {tiles}")
