"""The TANIMOTO engine's and the minhash / rbh schemes' modules against the JAX
package's, from the same numpy inputs: match_tanimoto, tanimoto_exact, the
packed bucket format, minhash and rbh hashing with the parameters carried
over by `params_from_numpy`, the scheme registry; and the kernel layer's
build rules for the three new kernels (the wrappers against the reference
kernels are in tests/test_torch_tanimoto_kernels.py).  Everything from the
signatures on is integer: equality, no tolerance.

minhash is integer from end to end (fmix32 of element ids, a minimum, a
rehash), so its signatures are equal in every case.  rbh's one float step is
the grid cell floor((x - u) / g), held in two forms:
  (i)  dyadic u (multiples of 1/64), power-of-two pitches g and integer
       coordinates: the subtraction and the division are exact -> equal;
  (ii) the services' own Gamma / uniform parameters: a slot may differ only
       where some coordinate's float64 (x - u) / g lies within 1e-4 of an
       integer, and in at most 1e-3 of all slots."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.core import match as jmatch, packing as jpacking
from repro.core.lsh import minhash as jminhash, rbh as jrbh, rehash as jrehash
from repro.kernels import ref as jref
from repro_torch.core import lsh, match, packing
from repro_torch.core.lsh import minhash, rbh
from repro_torch.core.types import Engine
from repro_torch.kernels import build, common, ops, ref
from repro_torch.kernels.packed_tanimoto import (TILE_N, packed_tanimoto_count,
                                                 packed_tanimoto_topk)
from repro_torch.kernels.tanimoto_count import tanimoto_count


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# match_tanimoto, tanimoto_exact and the packed bucket format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,m", [(1, 5, 3), (3, 130, 17), (2, 90, 600)])
def test_match_tanimoto_equals_reference(q, n, m, rng):
    d = rng.integers(0, 64, size=(n, m)).astype(np.int32)
    s = rng.integers(0, 64, size=(q, m)).astype(np.int32)
    got = match.match_tanimoto(_t(d), _t(s))
    want = np.asarray(jmatch.match_tanimoto(jnp.asarray(d), jnp.asarray(s)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.match_tanimoto(_t(d), _t(s), chunk=5).numpy(),
                          np.asarray(jref.match_tanimoto(jnp.asarray(d), jnp.asarray(s))))


@pytest.mark.parametrize("q,n,v", [(3, 40, 17), (5, 33, 64)])
def test_tanimoto_exact_equals_reference_bit_for_bit(q, n, v, rng):
    """float32 sum-min over max(sum-max, 1): the same integer sums and the
    same float32 division, so the values are equal, not close."""
    d = rng.integers(0, 4, size=(n, v)).astype(np.int32)
    s = rng.integers(0, 4, size=(q, v)).astype(np.int32)
    d[0] = 0                                    # an empty row against any query: 0 / max(., 1)
    s[0] = 0
    got = match.tanimoto_exact(_t(d), _t(s))
    want = np.asarray(jmatch.tanimoto_exact(jnp.asarray(d), jnp.asarray(s)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.tanimoto_exact(_t(d), _t(s)).numpy(), want)
    assert got[0, 0] == 0.0


def test_pack_buckets_domain_and_error_text_equal_reference():
    ok = np.array([[0, 253], [7, 100]], np.int32)
    packed = packing.pack_buckets(_t(ok))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), ok)
    assert np.array_equal(packed.numpy(), np.asarray(jpacking.pack_buckets(jnp.asarray(ok))))
    for bad in ([[254]], [[255]], [[-1]], [[3, 8192]]):
        arr = np.array(bad, np.int32)
        with pytest.raises(ValueError) as ours:
            packing.pack_buckets(_t(arr))
        with pytest.raises(ValueError) as theirs:
            jpacking.pack_buckets(jnp.asarray(arr))
        assert str(ours.value) == str(theirs.value)
    assert (packing.PACKED_BUCKET_PAD_DATA, packing.PACKED_BUCKET_PAD_QUERY,
            packing.PACKED_BUCKET_MAX) == (jpacking.PACKED_BUCKET_PAD_DATA,
                                           jpacking.PACKED_BUCKET_PAD_QUERY,
                                           jpacking.PACKED_BUCKET_MAX)


def test_packed_tanimoto_match_equals_reference(rng):
    d = rng.integers(0, 254, size=(17, 9)).astype(np.int32)
    s = rng.integers(0, 254, size=(4, 9)).astype(np.int32)
    s[0] = d[3]
    got = packing.packed_tanimoto_match(packing.pack_buckets(_t(d)), packing.pack_buckets(_t(s)))
    want = np.asarray(jpacking.packed_tanimoto_match(jpacking.pack_buckets(jnp.asarray(d)),
                                                     jpacking.pack_buckets(jnp.asarray(s))))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(jmatch.match_tanimoto(jnp.asarray(d), jnp.asarray(s))))
    assert int(got[0, 3]) == 9
    assert packing.packed_bytes_tanimoto(_t(d)) == jpacking.packed_bytes_tanimoto(jnp.asarray(d))


# ---------------------------------------------------------------------------
# The kernel layer's rules for the three new kernels
# ---------------------------------------------------------------------------

def test_wrappers_refuse_what_no_kernel_takes(rng):
    d8 = torch.empty((10, 7), dtype=torch.uint8, device="meta")
    for call in (lambda: packed_tanimoto_count(d8, d8[:2]),
                 lambda: packed_tanimoto_topk(d8, d8[:2], 3),
                 lambda: tanimoto_count(torch.empty((3, 4), dtype=torch.int32, device="meta"),
                                        torch.empty((1, 4), dtype=torch.int32, device="meta"))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    d = packing.pack_buckets(_t(rng.integers(0, 200, size=(10, 7)).astype(np.int32)))
    with pytest.raises(ValueError, match="k must be >= 1"):
        packed_tanimoto_topk(d, d[:2], 0)
    common.reset_launch_counts()
    ops.tanimoto_count(d, d[:2])                 # the entry casts to int32
    ops.packed_tanimoto_count(d.to(torch.int32), d[:2])
    ops.packed_tanimoto_topk(d, d[:2], k=4)
    assert common.launch_counts() == {}          # the CPU path launches nothing


def test_tile_headers_and_sources_are_what_the_build_sees():
    """The wrapper's TILE_N is the fused kernel's K_TN; EQ and TANIMOTO WIDE
    run the equality tile of eq_tile.cuh, packed TANIMOTO a tile of its own
    (bytes widened to float16 lanes and compared there);
    both fused kernels include the fused kernel's header."""
    src = (build.CSRC_DIR / "packed_tanimoto.cu").read_text()
    header = (build.CSRC_DIR / "fused_topk.cuh").read_text()
    assert int(re.search(r"constexpr int K_TN = (\d+);", header).group(1)) == TILE_N
    assert '#include "fused_topk.cuh"' in src
    for name, body in (("match_count.cu", "eq_tile::count_eq_tile("),
                       ("tanimoto_count.cu", "eq_tile::count_eq_tile(")):
        text = (build.CSRC_DIR / name).read_text()
        assert '#include "eq_tile.cuh"' in text
        assert body in text
    assert [p.name for p in build.headers()] == ["eq_tile.cuh", "fused_topk.cuh",
                                                 "s8_mma_tile.cuh"]
    count = src[src.index("namespace count {"):src.index("}  // namespace count")]
    assert "set.eq.f16x2.f16x2" in count and "__byte_perm(" in count   # float16 lanes alone
    assert "eq_lanes(" not in count
    assert "count_tile<" not in src and '#include "eq_tile.cuh"' not in src
    # the byte-lane compare: the data and query pads are the reference's sentinels
    assert f"PAD_DATA = {packing.PACKED_BUCKET_PAD_DATA};" in src
    assert f"PAD_QUERY = {packing.PACKED_BUCKET_PAD_QUERY};" in src


def test_fused_kernel_shapes_and_bins_threshold_are_what_the_source_says():
    """The fused kernel's two shapes (one-byte counts for 64 query rows up to
    m = 254, two-byte counts for 32 above, 128 KB either way), the widest m
    the wrapper admits, and the m up to which the rows' bins fit beside the
    tile and the staged words (503, as the plan's note says)."""
    from repro_torch.kernels.packed_tanimoto import TOPK_MAX_M

    src = (build.CSRC_DIR / "packed_tanimoto.cu").read_text()
    header = (build.CSRC_DIR / "fused_topk.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (K_\w+|MAX_SMEM) = (\d+);", header)}
    shapes = dict(re.findall(r"using (CountU\d+) = Fused<(uint\d+_t, \d+, \d+)>;", src))
    assert shapes == {"CountU8": "uint8_t, 64, 16", "CountU16": "uint16_t, 32, 16"}
    assert TOPK_MAX_M == 2 ** 16 - 2
    threads, rq, rn, tn = const["K_THREADS"], const["K_RQ"], const["K_RN"], const["K_TN"]

    def fixed(count_bytes, tq, kw):
        sn = threads // (tq // rq) * rn
        return tq * tn * count_bytes + (sn * (kw + 1) + tq * kw) * 4

    def last_m_in_shared(count_bytes, tq, kw):
        return (const["MAX_SMEM"] - fixed(count_bytes, tq, kw)) // (tq * 4) - 1

    assert 64 * tn == 32 * tn * 2 == 128 * 1024                      # 128 KB tiles
    assert last_m_in_shared(1, 64, 16) >= 254                        # always shared
    assert last_m_in_shared(2, 32, 16) == 503
    assert "m > 503" in src and "m <= 503" in src


def test_zero_byte_lane_count_is_exact():
    """The kernels count equal byte lanes as the zero bytes of q ^ d by the
    carry-free test; checked here in numpy on every byte value and on words
    whose lanes mix equal and unequal bytes."""
    def eq_lanes(a, b):
        x = (a ^ b) & 0xFFFFFFFF
        y = ((x & 0x7F7F7F7F) + 0x7F7F7F7F) & 0xFFFFFFFF
        t = ~(y | x) & 0x80808080
        return bin(int(t)).count("1")

    for v in range(256):
        assert eq_lanes(v, 0) == (4 if v == 0 else 3)
        assert eq_lanes(v * 0x01010101, 0x80808080) == (4 if v == 0x80 else 0)
    rng = np.random.default_rng(1)
    for _ in range(2000):
        a, b = (int(x) for x in rng.integers(0, 2**32, size=2, dtype=np.uint64))
        keep = int(rng.integers(0, 16))
        mask = sum(0xFF << (8 * i) for i in range(4) if keep >> i & 1)
        b = (a & mask) | (b & ~mask & 0xFFFFFFFF)
        want = sum(((a >> (8 * i)) & 0xFF) == ((b >> (8 * i)) & 0xFF) for i in range(4))
        assert eq_lanes(a, b) == want


# ---------------------------------------------------------------------------
# minhash
# ---------------------------------------------------------------------------

def _carry_minhash(jparams):
    return minhash.params_from_numpy(np.asarray(jparams.seeds), np.asarray(jparams.rehash_seeds),
                                     jparams.n_buckets, device="cpu")


@pytest.mark.parametrize("n_buckets", [128, 8192])
def test_minhash_hash_points_equals_reference(n_buckets, rng):
    """Integer throughout: equal.  Row 0 has no positive entry: its minimum is
    0xFFFFFFFF, which the reference casts to int32 -1 and rehashes as
    0xFFFFFFFF -- the port gives the same bucket ids."""
    jparams = jminhash.make(jax.random.PRNGKey(1), m=40, n_buckets=n_buckets)
    params = _carry_minhash(jparams)
    assert params.dims == (40, None)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    x[0] = -1.0                                 # the empty set
    x[1] = 0.0                                  # zeros are not in the support either
    got = minhash.hash_points(params, _t(x))
    want = np.asarray(jminhash.hash_points(jparams, jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    minus_one = np.full((1, 40), -1, np.int32)
    assert np.array_equal(got.numpy()[:2], np.repeat(np.asarray(jrehash.rehash(
        jnp.asarray(minus_one), jparams.rehash_seeds, n_buckets)), 2, axis=0))
    assert int(got.min()) >= 0 and int(got.max()) < n_buckets


def test_minhash_hash_sets_equals_reference(rng):
    jparams = jminhash.make(jax.random.PRNGKey(2), m=33, n_buckets=500)
    params = _carry_minhash(jparams)
    elements = rng.integers(-2**31, 2**31, size=(60, 17)).astype(np.int32)
    valid = rng.random((60, 17)) > 0.3
    valid[0] = False                            # the empty set
    valid[1] = True
    got = minhash.hash_sets(params, _t(elements), _t(valid))
    want = np.asarray(jminhash.hash_sets(jparams, jnp.asarray(elements), jnp.asarray(valid)))
    assert np.array_equal(got.numpy(), want)
    # a set's signature does not depend on the order of its elements
    perm = rng.permutation(17)
    again = minhash.hash_sets(params, _t(elements[:, perm]), _t(valid[:, perm]))
    assert torch.equal(again, got)
    a, av = elements[2], valid[2]
    assert minhash.jaccard(a, av, a, av) == jminhash.jaccard(a, av, a, av) == 1.0
    assert minhash.jaccard(a, av, elements[3], valid[3]) == jminhash.jaccard(
        a, av, elements[3], valid[3])
    assert minhash.jaccard([], [], [], []) == 1.0


def test_minhash_make_and_params_from_numpy():
    p1 = minhash.make(torch.Generator().manual_seed(5), d=16, m=30, n_buckets=64,
                      device="cpu")
    p2 = minhash.make(torch.Generator().manual_seed(5), m=30, n_buckets=64, device="cpu")
    assert p1.seeds.dtype == torch.int64 and p1.dims == (30, None)
    assert torch.equal(p1.seeds, p2.seeds) and torch.equal(p1.rehash_seeds, p2.rehash_seeds)
    assert not torch.equal(p1.seeds, p1.rehash_seeds)
    sig = minhash.hash_points(p1, torch.randn(10, 16, generator=torch.Generator().manual_seed(1)))
    assert tuple(sig.shape) == (10, 30) and int(sig.min()) >= 0 and int(sig.max()) < 64
    with pytest.raises(ValueError, match="expected seeds"):
        minhash.params_from_numpy(np.zeros((3, 2)), np.zeros((3, 2)), 8, device="cpu")
    big = minhash.params_from_numpy(np.array([0xFFFFFFFF], np.uint32),
                                    np.array([2**31], np.uint32), 8, device="cpu")
    assert big.seeds.tolist() == [0xFFFFFFFF] and big.rehash_seeds.tolist() == [2**31]


# ---------------------------------------------------------------------------
# rbh
# ---------------------------------------------------------------------------

def _carry_rbh(jparams):
    return rbh.params_from_numpy(np.asarray(jparams.g), np.asarray(jparams.u),
                                 np.asarray(jparams.dim_seeds), jparams.sigma, jparams.n_buckets,
                                 device="cpu")


def _dyadic_rbh(rng, m, d, n_buckets=8192):
    g = (2.0 ** rng.integers(-1, 3, size=(m, d))).astype(np.float32)
    u = (rng.integers(0, 64, size=(m, d)) / 64.0 * g).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=(m, d)).astype(np.uint32)
    seeds[0, 0] = 0xFFFFFFFF                    # a seed with the top bit set
    return jrbh.RBHParams(g=jnp.asarray(g), u=jnp.asarray(u), dim_seeds=jnp.asarray(seeds),
                          sigma=1.0, n_buckets=n_buckets)


def test_rbh_dyadic_is_equal(rng):
    """Form (i): exact float32 arithmetic, cells and signatures equal slot for
    slot, negative cells included."""
    jparams = _dyadic_rbh(rng, m=24, d=12)
    params = _carry_rbh(jparams)
    x = rng.integers(-20, 21, size=(300, 12)).astype(np.float32)
    raw = rbh.raw_hash(params, _t(x))
    assert raw.dtype == torch.int32 and tuple(raw.shape) == (300, 24, 12)
    assert np.array_equal(raw.numpy(), np.asarray(jrbh.raw_hash(jparams, jnp.asarray(x))))
    assert int(raw.min()) < 0 < int(raw.max())
    sig = rbh.hash_points(params, _t(x))
    assert sig.dtype == torch.int32
    assert np.array_equal(sig.numpy(), np.asarray(jrbh.hash_points(jparams, jnp.asarray(x))))


def test_rbh_gaussian_differs_only_at_cell_boundaries(rng):
    """Form (ii): the services' own parameters (Gamma pitches, uniform
    shifts) and Gaussian points."""
    jparams = jrbh.make(jax.random.PRNGKey(3), d=32, m=60, sigma=2.5, n_buckets=8192)
    params = _carry_rbh(jparams)
    assert params.dims == (60, 32)
    x = rng.standard_normal((1000, 32)).astype(np.float32) * 3.0
    got = rbh.hash_points(params, _t(x)).numpy()
    want = np.asarray(jrbh.hash_points(jparams, jnp.asarray(x)))
    differ = got != want
    assert differ.mean() <= 1e-3
    cells = ((x.astype(np.float64)[:, None, :] - np.asarray(jparams.u, np.float64))
             / np.asarray(jparams.g, np.float64))
    near = (np.abs(cells - np.round(cells)) < 1e-4).any(axis=-1)
    assert np.all(near[differ])


def test_rbh_make_kernel_and_sigma(rng):
    gen = torch.Generator().manual_seed(5)
    p1 = rbh.make(gen, d=8, m=200, sigma=2.0, n_buckets=64, device="cpu")
    p2 = rbh.make(torch.Generator().manual_seed(5), d=8, m=200, sigma=2.0, n_buckets=64,
                  device="cpu")
    assert p1.g.dtype == torch.float32 and p1.dim_seeds.dtype == torch.int64
    assert p1.dims == (200, 8) and torch.equal(p1.g, p2.g) and torch.equal(p1.u, p2.u)
    assert bool((p1.g > 0).all()) and bool((p1.u >= 0).all()) and bool((p1.u <= p1.g).all())
    # Gamma(2, sigma) has mean 2 * sigma: 1600 draws land well inside 10 %
    assert abs(float(p1.g.mean()) - 4.0) < 0.4
    sig = rbh.hash_points(p1, torch.randn(10, 8, generator=gen))
    assert int(sig.min()) >= 0 and int(sig.max()) < 64
    with pytest.raises(ValueError, match="expected g, u and dim_seeds"):
        rbh.params_from_numpy(np.zeros((3, 2)), np.zeros((3, 3)), np.zeros((3, 2)), 1.0, 8,
                              device="cpu")
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.standard_normal((6, 8)).astype(np.float32)
    assert np.allclose(rbh.kernel(_t(x), _t(y), 2.0).numpy(),
                       np.asarray(jrbh.kernel(jnp.asarray(x), jnp.asarray(y), 2.0)),
                       rtol=1e-6, atol=0)
    pts = _t(rng.standard_normal((50, 8)).astype(np.float32))
    sigma = rbh.median_heuristic_sigma(pts, torch.Generator().manual_seed(0), n_pairs=64)
    again = rbh.median_heuristic_sigma(pts, torch.Generator().manual_seed(0), n_pairs=64)
    assert sigma == again and 0.0 < sigma < float(torch.cdist(pts, pts, p=1).max())


# ---------------------------------------------------------------------------
# The scheme registry: all four families of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rbh", "minhash"])
def test_new_schemes_pair_with_the_reference_engines(name):
    scheme, jscheme = lsh.get_scheme(name), jlsh.get_scheme(name)
    assert scheme.engine.value == jscheme.engine.value
    assert scheme.engine is (Engine.TANIMOTO if name == "minhash" else Engine.EQ)
    assert scheme.option_names == jscheme.option_names
    assert scheme.description == jscheme.description
    params = scheme.make_params(torch.Generator().manual_seed(0), d=6, m=10,
                                w=4.0, sigma=1.5, n_buckets=32, device="cpu")
    assert params.n_buckets == 32 and params.dims[0] == 10
    counts = np.array([[10, 4, 0]])
    assert np.array_equal(scheme.mle(counts, 10), jscheme.mle(counts, 10))
