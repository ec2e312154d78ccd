"""The COSINE kernel layer against the JAX package's: the same numpy inputs go
through `repro.kernels.ops` (the Pallas kernels in interpret mode at small
tiles, as tests/test_kernels.py and tests/test_packed.py run them) and
through `repro_torch.kernels.ops` on the CPU, where the wrappers take their
plain PyTorch versions (the CUDA kernels themselves are held against the
same plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py).
Everything is integer: equality, no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import cpq as jcpq, match as jmatch, packing as jpacking
from repro.core.types import SearchParams as JSearchParams
from repro.kernels import ops as jops
from repro_torch.core import GenieIndex, packing
from repro_torch.core.plan import _fused_candidates_topk
from repro_torch.kernels import ops
from repro_torch.kernels.cosine_count import cosine_count, cosine_count_plain
from repro_torch.kernels.packed_cosine import (TILE_N, packed_cosine_count,
                                               packed_cosine_count_plain,
                                               packed_cosine_topk_plain)


def _signs(rng, n, v):
    return (rng.integers(0, 2, (n, v)) * 2 - 1).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _packed(d, s):
    """(port data words, port query words, reference data words, reference
    query words)."""
    return (packing.pack_signs_data(_t(d)), packing.pack_signs_queries(_t(s)),
            jpacking.pack_signs_data(jnp.asarray(d)), jpacking.pack_signs_queries(jnp.asarray(s)))


# ---------------------------------------------------------------------------
# The three kernel wrappers (plain on the CPU) against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,v", [(2, 90, 33), (4, 300, 256), (1, 40, 513)])
def test_cosine_count_equals_reference_kernel(q, n, v, rng):
    db, qb = _signs(rng, n, v), _signs(rng, q, v)
    got = ops.cosine_count(_t(db), _t(qb).to(torch.int32))    # the entry casts to int8
    kernel = np.asarray(jops.cosine_count(jnp.asarray(db), jnp.asarray(qb),
                                          tile_q=8, tile_n=128, tile_v=128))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert torch.equal(cosine_count(_t(db), _t(qb)), cosine_count_plain(_t(db), _t(qb)))


@pytest.mark.parametrize("v", [1, 31, 32, 33, 127, 128, 129, 238, 240, 8195])
def test_cosine_count_across_the_tile_steps_equals_reference_kernel(v, rng):
    """V across the steps of the int8 tensor-core tile (csrc/s8_mma_tile.cuh):
    its 32-byte MMA depth and 128-byte stage, 238 (SIFT's m) and past 8192;
    Q and N multiples of neither 64 nor 256, zero pad rows among the data."""
    q, n = 67, 301
    db, qb = _signs(rng, n, v), _signs(rng, q, v)
    db[::9] = 0                                          # pad rows floor to V // 2
    got = cosine_count(_t(db), _t(qb))
    kernel = np.asarray(jops.cosine_count(jnp.asarray(db), jnp.asarray(qb),
                                          tile_q=8, tile_n=128, tile_v=128))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert int(got[0, 0]) == v // 2


@pytest.mark.parametrize("n,q,v", [(7, 3, 33), (130, 5, 64), (64, 4, 513)])
def test_packed_cosine_count_equals_reference_kernel(n, q, v):
    rng = np.random.default_rng(n * v)
    dw, sw, jdw, jsw = _packed(_signs(rng, n, v), _signs(rng, q, v))
    got = ops.packed_cosine_count(dw, sw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jops.packed_cosine_count(jdw, jsw)))
    assert torch.equal(packed_cosine_count(dw, sw), packed_cosine_count_plain(dw, sw))


def _reference_tile(n: int) -> int:
    """The tile the TPU wrapper picks (kernels/common.pick_tile, 256 / 128)."""
    return 256 if n >= 256 else -(-n // 128) * 128


@pytest.mark.parametrize("n,q,v,k", [(130, 5, 64, 10), (300, 4, 95, 7), (600, 2, 238, 5)])
def test_packed_cosine_topk_equals_reference_kernel(n, q, v, k):
    """At the reference's tile the plain buffers equal the Pallas kernel's
    slot for slot; at the port's own tile they differ in width, and the
    merged result equals the reference's and a sort of the counts."""
    rng = np.random.default_rng(n + v)
    d, s = _signs(rng, n, v), _signs(rng, q, v)
    dw, sw, jdw, jsw = _packed(d, s)
    jids, jcnts = jops.packed_cosine_topk(jdw, jsw, k=k)
    pids, pcnts = packed_cosine_topk_plain(dw, sw, k, tile_n=_reference_tile(n))
    assert np.array_equal(pids.numpy(), np.asarray(jids))
    assert np.array_equal(pcnts.numpy(), np.asarray(jcnts))

    ids, cnts = ops.packed_cosine_topk(dw, sw, k=k)          # the port's tile
    assert tuple(ids.shape) == (q, -(-n // TILE_N) * min(k, TILE_N))
    got = _fused_candidates_topk(lambda *_: (ids, cnts), None, None, k)
    want = jcpq.topk_from_candidates(jids, jcnts, k)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    counts = jmatch.match_cosine(jnp.asarray(d), jnp.asarray(s))
    oracle = jcpq.sort_select(counts, JSearchParams(k=k, max_count=v))
    assert np.array_equal(got[0].numpy(), np.asarray(oracle.ids))
    assert np.array_equal(got[1].numpy(), np.asarray(oracle.counts))


@pytest.mark.parametrize("n,k,tile_n", [(5000, 3, 2048), (50, 100, 2048), (2100, 2500, 2048),
                                        (700, 9, 64), (3, 8, 4)])
def test_plain_topk_buffers_follow_the_contract(n, k, tile_n, rng):
    """Tiles ascending, (count desc, id asc) inside a tile, no id past N,
    exhausted slots -1 / -1, kc = min(k, tile_n) slots per tile."""
    v = 40
    dw = packing.pack_signs_data(_t(_signs(rng, n, v)))
    sw = packing.pack_signs_queries(_t(_signs(rng, 3, v)))
    ids, cnts = packed_cosine_topk_plain(dw, sw, k, tile_n=tile_n)
    counts = packed_cosine_count_plain(dw, sw).numpy()
    kc, n_tiles = min(k, tile_n), -(-n // tile_n)
    assert tuple(ids.shape) == (3, n_tiles * kc)
    for row in range(3):
        for t in range(n_tiles):
            sl = slice(t * kc, (t + 1) * kc)
            i, c = ids[row, sl].numpy(), cnts[row, sl].numpy()
            lo, hi = t * tile_n, min((t + 1) * tile_n, n)
            real = i >= 0
            assert np.all((c == -1) == ~real) and np.all(real[:real.sum()])
            assert np.all((i[real] >= lo) & (i[real] < hi))
            assert np.array_equal(c[real], counts[row, i[real]])
            order = sorted(zip(-counts[row, lo:hi], range(lo, hi)))[:kc]
            assert [j for _, j in order] == i[real].tolist()


def test_fused_tie_break_is_count_desc_id_asc():
    """All-equal counts: the buffers surface the lowest ids, as in the
    reference (tests/test_packed.py)."""
    d = torch.ones((40, 8), dtype=torch.int8)
    s = torch.ones((2, 8), dtype=torch.int8)
    ids, cnts = ops.packed_cosine_topk(packing.pack_signs_data(d),
                                       packing.pack_signs_queries(s), k=5)
    got_ids, got_cnts = _fused_candidates_topk(lambda *_: (ids, cnts), None, None, 5)
    assert got_ids.tolist() == [list(range(5))] * 2
    assert bool((got_cnts == 8).all())


@pytest.mark.parametrize("k", [8, TILE_N + 52])
def test_packed_search_tiny_corpus_fills_missing_slots(k):
    """n < k: the fused path pads its result to k slots with (-1, -1), like
    the WIDE selector -- also when k exceeds the tile, where the candidate
    buffer itself is narrower than k."""
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((3, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    wide = GenieIndex.build_cosine(raw, device="cpu").search(q, k=k)
    packed = GenieIndex.build_cosine(raw, signature_layout="packed", device="cpu").search(q, k=k)
    jwide = JGenieIndex.build_cosine(raw, use_kernel=False).search(q, k=k)
    jpacked = JGenieIndex.build_cosine(raw, signature_layout="packed").search(q, k=k)
    for res, want in ((wide, jwide), (packed, jpacked)):
        assert np.array_equal(res.ids.numpy(), np.asarray(jpacked.ids))
        assert np.array_equal(res.counts.numpy(), np.asarray(jpacked.counts))
        # the thresholds differ between the paths, in both packages alike: the
        # fused path reads the k-th count (-1), c-PQ's gate gives AT - 1 = 0
        assert np.array_equal(res.threshold.numpy(), np.asarray(want.threshold))
    assert packed.threshold.tolist() == [-1, -1] and wide.threshold.tolist() == [0, 0]
    assert bool((packed.ids[:, 3:] == -1).all()) and bool((packed.counts[:, 3:] == -1).all())
