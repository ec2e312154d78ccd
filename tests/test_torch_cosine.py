"""The COSINE engine's modules against the JAX package's: match_cosine, the
packed sign format and simhash, from the same numpy inputs; and the kernel
layer's build and dispatch rules (the wrappers against the reference kernels
are in tests/test_torch_cosine_kernels.py).  Everything from the signatures on
is integer: equality, no tolerance.

The one float step is simhash's sign of x.v, held in two forms:
  (i)  dyadic v (multiples of 1/64) and integer coordinates: every float32
       product and sum is exact in any order -> signatures equal, including
       projections of exactly 0 (and -0.0), which hash to 1;
  (ii) Gaussian v as the services draw it: a bit may differ only where a
       float64 x.v lies within 1e-4 * |x| * |v| of 0, and in at most 1e-3 of
       all slots."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import match as jmatch, packing as jpacking
from repro.core.lsh import simhash as jsimhash
from repro.kernels import ref as jref
from repro_torch.core import match, packing
from repro_torch.core.lsh import simhash
from repro_torch.kernels import build, common, ops, ref
from repro_torch.kernels.cosine_count import cosine_count
from repro_torch.kernels.packed_cosine import TILE_N, packed_cosine_count, packed_cosine_topk


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
# match_cosine and the packed format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,v", [(1, 5, 3), (3, 130, 17), (8, 300, 64), (5, 257, 33)])
def test_match_cosine_equals_reference(q, n, v, rng):
    d, s = _signs(rng, n, v), _signs(rng, q, v)
    d[::3] = 0                                  # zero pad rows floor to V // 2
    got = match.match_cosine(_t(d), _t(s))
    want = np.asarray(jmatch.match_cosine(jnp.asarray(d), jnp.asarray(s)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.match_cosine(_t(d), _t(s)).numpy(),
                          np.asarray(jref.match_cosine(jnp.asarray(d), jnp.asarray(s))))
    assert np.all(got.numpy()[:, ::3] == v // 2)


@pytest.mark.parametrize("v", [1, 31, 32, 33, 64, 513])
def test_pack_signs_round_trip_equals_reference(v):
    rng = np.random.default_rng(v)
    signs = _signs(rng, 9, v)
    signs[0] = 1                                # all-ones words: bit 31 set, int32 -1
    dw, sw, jdw, jsw = _packed(signs, signs)
    for got, want in ((dw, jdw), (sw, jsw)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (9, packing.packed_words(v))
        assert np.array_equal(got.numpy(), np.asarray(want))
    back = packing.unpack_signs(dw, v)
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), signs)
    assert np.array_equal(back.numpy(), np.asarray(jpacking.unpack_signs(jdw, v)))
    assert packing.packed_bytes_cosine(_t(signs)) == jpacking.packed_bytes_cosine(jnp.asarray(signs))


@pytest.mark.parametrize("v", [1, 31, 33, 95])
def test_packed_cosine_match_tail_bits_equal_reference(v):
    """Data tail bits 0 vs query tail bits 1: agreements = 32W - popcount."""
    rng = np.random.default_rng(v)
    d, s = _signs(rng, 13, v), _signs(rng, 3, v)
    dw, sw, jdw, jsw = _packed(d, s)
    want = np.asarray(jmatch.match_cosine(jnp.asarray(d), jnp.asarray(s)))
    assert np.array_equal(packing.packed_cosine_match(dw, sw).numpy(), want)
    assert np.array_equal(np.asarray(jpacking.packed_cosine_match(jdw, jsw)), want)
    assert np.array_equal(ref.packed_cosine_match(dw, sw, chunk=3).numpy(), want)


def test_popcount_of_edge_words():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xAAAAAAAA, 0x12345678],
                     dtype=np.int64)
    got = packing._popcount32(torch.from_numpy(words.copy())).numpy()
    assert got.tolist() == [bin(int(x)).count("1") for x in words]


def test_wrappers_refuse_what_no_kernel_takes(rng):
    dw = packing.pack_signs_data(_t(_signs(rng, 10, 40))).to("meta")
    sw = torch.empty((2, 2), dtype=torch.int32, device="meta")
    for call in (lambda: packed_cosine_count(dw, sw), lambda: packed_cosine_topk(dw, sw, 3),
                 lambda: cosine_count(torch.empty((3, 4), dtype=torch.int8, device="meta"),
                                      torch.empty((1, 4), dtype=torch.int8, device="meta"))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    with pytest.raises(ValueError, match="k must be >= 1"):
        packed_cosine_topk(packing.pack_signs_data(_t(_signs(rng, 10, 40))),
                           packing.pack_signs_queries(_t(_signs(rng, 2, 40))), 0)
    common.reset_launch_counts()
    d = _t(_signs(rng, 30, 40))
    ops.cosine_count(d, d[:2])
    ops.packed_cosine_topk(packing.pack_signs_data(d), packing.pack_signs_queries(d[:2]), k=4)
    assert common.launch_counts() == {}                # the CPU path launches nothing


def test_tile_and_header_are_what_the_build_sees(monkeypatch, tmp_path):
    """The wrapper's TILE_N is the fused kernel's K_TN (in the fused kernel's
    header, which packed_cosine.cu includes), and an edit to a header alone
    changes the library's digest (it is hashed, not compiled)."""
    src = (build.CSRC_DIR / "packed_cosine.cu").read_text()
    header = (build.CSRC_DIR / "fused_topk.cuh").read_text()
    assert int(re.search(r"constexpr int K_TN = (\d+);", header).group(1)) == TILE_N
    assert [p.name for p in build.headers()] == ["eq_tile.cuh", "fused_topk.cuh",
                                                 "s8_mma_tile.cuh"]
    assert '#include "fused_topk.cuh"' in src
    for p in build.sources() + build.headers():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build._digest(build.sources())
    (tmp_path / "fused_topk.cuh").write_text(
        (tmp_path / "fused_topk.cuh").read_text() + "\n// edited\n")
    assert build._digest(build.sources()) != before
    assert [p.name for p in build.sources()] == [
        "cosine_count.cu", "cpq_compact.cu", "cpq_hist.cu", "ip_count.cu", "match_count.cu",
        "minsum_count.cu", "packed_cosine.cu", "packed_tanimoto.cu", "range_count.cu",
        "tanimoto_count.cu"]


# ---------------------------------------------------------------------------
# simhash
# ---------------------------------------------------------------------------

def test_hash_points_dyadic_is_equal(rng):
    """Form (i), zero projections included."""
    m, d = 48, 24
    v = rng.integers(-128, 129, size=(m, d)).astype(np.float32) / 64.0
    x = rng.integers(-50, 51, size=(400, d)).astype(np.float32)
    x[:3] = 0.0                                 # projections of exactly 0 and -0.0
    x[3, :] = 0.0
    x[3, 0] = 64.0
    v[0, 0] = 0.0                               # x[3] . v[0] == 0
    params = simhash.params_from_numpy(v, device="cpu")
    got = simhash.hash_points(params, _t(x))
    want = np.asarray(jsimhash.hash_points(jsimhash.SimHashParams(v=jnp.asarray(v)),
                                           jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.all(got.numpy()[:3] == 1) and got.numpy()[3, 0] == 1
    assert int(got.min()) == 0 and int(got.max()) == 1


def test_hash_points_gaussian_differs_only_near_zero(rng):
    """Form (ii): the services' own Gaussian parameters."""
    jparams = jsimhash.make(jax.random.PRNGKey(3), d=64, m=120)
    params = simhash.params_from_numpy(np.asarray(jparams.v), device="cpu")
    assert params.dims == (120, 64)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    got = simhash.hash_points(params, _t(x)).numpy()
    want = np.asarray(jsimhash.hash_points(jparams, jnp.asarray(x)))
    differ = got != want
    assert differ.mean() <= 1e-3
    vv = np.asarray(jparams.v, np.float64)
    exact = x.astype(np.float64) @ vv.T
    scale = np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(vv, axis=1)[None, :]
    assert np.all((np.abs(exact) < 1e-4 * scale)[differ])


def test_simhash_make_params_and_mle():
    gen = torch.Generator().manual_seed(5)
    p1 = simhash.make(gen, d=16, m=30, device="cpu")
    p2 = simhash.make(torch.Generator().manual_seed(5), d=16, m=30, device="cpu")
    assert p1.v.dtype == torch.float32 and p1.dims == (30, 16) and torch.equal(p1.v, p2.v)
    with pytest.raises(ValueError, match="expected v"):
        simhash.params_from_numpy(np.zeros(4), device="cpu")
    counts = np.array([[-1, 0, 7, 30, 31], [15, 16, 29, 2, 30]])
    assert np.array_equal(simhash.mle_cosine(counts, 30), jsimhash.mle_cosine(counts, 30))
