"""The port's LSH transform against the JAX package's, parameters carried
over as numpy arrays so both hash with identical functions.

Everything integer (fmix32, rehash) must be equal.  The one float step is
`raw_hash`, floor((x.a + b)/w): a float32 product summed in another order can
flip a bucket at a boundary.  So hashing is held in two forms:
  (i)  dyadic inputs (a, b multiples of 1/64, integer coordinates, w = 4,
       d <= 32): every float32 sum is exact in any order -> signatures equal;
  (ii) Gaussian parameters as the services draw them: a slot may differ only
       where a float64 evaluation of (x.a + b)/w lies within 1e-4 of an
       integer, and in at most 1e-3 of all slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.core.lsh import e2lsh as je2lsh, rehash as jrehash, tau_ann as jtau
from repro_torch.core import lsh
from repro_torch.core.lsh import e2lsh, rehash, tau_ann
from repro_torch.core.types import Engine

_EDGE = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x7FFF, -0x8000, 12345, -98765], np.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_fmix32_equals_reference(rng):
    x = np.concatenate([_EDGE, rng.integers(-2**31, 2**31, size=4000).astype(np.int32)])
    got = rehash.fmix32(torch.from_numpy(x))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    assert np.array_equal(_u32(got), np.asarray(jrehash.fmix32(jnp.asarray(x))))


def test_hash_combine_equals_reference(rng):
    acc = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    val = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    got = rehash.hash_combine(torch.from_numpy(acc.astype(np.int64)),
                              torch.from_numpy(val.astype(np.int64)))
    assert np.array_equal(_u32(got), np.asarray(jrehash.hash_combine(jnp.asarray(acc), jnp.asarray(val))))


@pytest.mark.parametrize("n_buckets", [67, 8192, 1, 2**31 - 1])
def test_rehash_equals_reference_with_negative_inputs(n_buckets, rng):
    m = 19
    sig = rng.integers(-2**31, 2**31, size=(300, m)).astype(np.int32)
    sig[:len(_EDGE), 0] = _EDGE
    seeds = rng.integers(0, 2**31 - 1, size=m).astype(np.uint32)
    seeds[0] = 0xFFFFFFFF                       # a seed with the top bit set
    got = rehash.rehash(torch.from_numpy(sig), torch.from_numpy(seeds.astype(np.int64)), n_buckets)
    want = np.asarray(jrehash.rehash(jnp.asarray(sig), jnp.asarray(seeds), n_buckets))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < n_buckets


def test_rehash_vector_equals_reference(rng):
    vec = rng.integers(-1000, 1000, size=(50, 6)).astype(np.int32)
    seeds = rng.integers(0, 2**31 - 1, size=6).astype(np.uint32)
    got = rehash.rehash_vector(torch.from_numpy(vec), torch.from_numpy(seeds.astype(np.int64)), 8192)
    want = np.asarray(jrehash.rehash_vector(jnp.asarray(vec), jnp.asarray(seeds), 8192))
    assert np.array_equal(got.numpy(), want)


def _carry_over(jparams):
    return e2lsh.params_from_numpy(np.asarray(jparams.a), np.asarray(jparams.b),
                                   np.asarray(jparams.seeds), jparams.w, jparams.p,
                                   jparams.n_buckets, device="cpu")


def _dyadic_params(rng, m, d, n_buckets=8192):
    a = rng.integers(-128, 129, size=(m, d)).astype(np.float32) / 64.0
    b = rng.integers(0, 256, size=(m,)).astype(np.float32) / 64.0
    seeds = rng.integers(0, 2**31 - 1, size=m).astype(np.uint32)
    return je2lsh.E2LSHParams(a=jnp.asarray(a), b=jnp.asarray(b), seeds=jnp.asarray(seeds),
                              w=4.0, p=2, n_buckets=n_buckets)


def test_hash_points_dyadic_is_equal(rng):
    """Form (i): exact float32 arithmetic, signatures equal slot for slot."""
    jparams = _dyadic_params(rng, m=40, d=32)
    params = _carry_over(jparams)
    x = rng.integers(-50, 51, size=(500, 32)).astype(np.float32)
    raw = e2lsh.raw_hash(params, torch.from_numpy(x))
    assert np.array_equal(raw.numpy(), np.asarray(je2lsh.raw_hash(jparams, jnp.asarray(x))))
    assert int(raw.min()) < 0 < int(raw.max())        # negative buckets are exercised
    sig = e2lsh.hash_points(params, torch.from_numpy(x))
    assert sig.dtype == torch.int32
    assert np.array_equal(sig.numpy(), np.asarray(je2lsh.hash_points(jparams, jnp.asarray(x))))


def test_hash_points_gaussian_differs_only_at_bucket_boundaries(rng):
    """Form (ii): the services' own Gaussian parameters."""
    jparams = je2lsh.make(jax.random.PRNGKey(3), d=64, m=120, w=4.0)
    params = _carry_over(jparams)
    x = rng.standard_normal((2000, 64)).astype(np.float32) * 3.0
    got = e2lsh.hash_points(params, torch.from_numpy(x)).numpy()
    want = np.asarray(je2lsh.hash_points(jparams, jnp.asarray(x)))
    differ = got != want
    assert differ.mean() <= 1e-3
    exact = (x.astype(np.float64) @ np.asarray(jparams.a, np.float64).T
             + np.asarray(jparams.b, np.float64)) / 4.0
    near_boundary = np.abs(exact - np.round(exact)) < 1e-4
    assert np.all(near_boundary[differ])


def test_params_from_numpy_carries_everything_over(rng):
    jparams = je2lsh.make(jax.random.PRNGKey(0), d=8, m=12, w=2.5, p=1, n_buckets=67)
    params = _carry_over(jparams)
    assert params.a.dtype == torch.float32 and params.seeds.dtype == torch.int64
    assert np.array_equal(params.a.numpy(), np.asarray(jparams.a))
    assert np.array_equal(params.b.numpy(), np.asarray(jparams.b))
    assert np.array_equal(_u32(params.seeds), np.asarray(jparams.seeds))
    assert (params.w, params.p, params.n_buckets) == (2.5, 1, 67)
    with pytest.raises(ValueError, match="expected a"):
        e2lsh.params_from_numpy(np.zeros((3, 2)), np.zeros(4), np.zeros(3), 4.0, 2, 8,
                                device="cpu")


def test_make_draws_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    p1 = e2lsh.make(gen, d=16, m=30, w=4.0, n_buckets=64, device="cpu")
    p2 = e2lsh.make(torch.Generator().manual_seed(5), d=16, m=30, w=4.0, n_buckets=64,
                    device="cpu")
    p3 = e2lsh.make(torch.Generator().manual_seed(6), d=16, m=30, w=4.0, n_buckets=64,
                    device="cpu")
    assert tuple(p1.a.shape) == (30, 16) and tuple(p1.b.shape) == (30,)
    assert p1.a.dtype == torch.float32 and p1.seeds.dtype == torch.int64
    assert torch.equal(p1.a, p2.a) and torch.equal(p1.b, p2.b) and torch.equal(p1.seeds, p2.seeds)
    assert not torch.equal(p1.a, p3.a)
    assert float(p1.b.min()) >= 0.0 and float(p1.b.max()) < 4.0
    assert int(p1.seeds.min()) >= 0 and int(p1.seeds.max()) < 2**31 - 1
    assert len(set(p1.seeds.tolist())) > 1
    cauchy = e2lsh.make(torch.Generator().manual_seed(5), d=16, m=30, w=4.0, p=1, device="cpu")
    assert cauchy.p == 1 and torch.isfinite(cauchy.a).all()
    with pytest.raises(ValueError, match="p-stable"):
        e2lsh.make(gen, d=4, m=4, w=4.0, p=3, device="cpu")
    sig = e2lsh.hash_points(p1, torch.randn(10, 16, generator=gen))
    assert int(sig.min()) >= 0 and int(sig.max()) < 64


def test_scheme_registry():
    assert lsh.scheme_names() == ("e2lsh", "minhash", "rbh", "simhash")
    assert lsh.scheme_names() == jlsh.scheme_names()
    scheme = lsh.get_scheme("e2lsh")
    jscheme = jlsh.get_scheme("e2lsh")
    assert scheme.engine is Engine.EQ and scheme.engine.value == jscheme.engine.value
    assert scheme.option_names == jscheme.option_names
    assert lsh.get_scheme(scheme) is scheme
    with pytest.raises(KeyError, match="unknown LSH scheme"):
        lsh.get_scheme("no-such-scheme")
    # options a family does not take are dropped, as in the reference
    params = scheme.make_params(torch.Generator().manual_seed(0), d=4, m=6,
                                w=4.0, sigma=1.0, n_buckets=32, device="cpu")
    assert params.n_buckets == 32 and tuple(params.a.shape) == (6, 4)
    counts = np.array([[6, 3, 0]])
    assert np.array_equal(scheme.mle(counts, 6), jscheme.mle(counts, 6))


@pytest.mark.parametrize("eps,delta", [(0.2, 0.2), (0.15, 0.1)])
def test_tau_ann_equals_reference(eps, delta):
    assert tau_ann.required_m(eps, delta) == jtau.required_m(eps, delta)
    assert tau_ann.m_theorem41(eps, delta) == jtau.m_theorem41(eps, delta)
    assert tau_ann.prob_within(50, 0.5, eps) == jtau.prob_within(50, 0.5, eps)
    assert tau_ann.min_m_for_similarity(0.3, eps, delta) == jtau.min_m_for_similarity(0.3, eps, delta)


@pytest.mark.parametrize("s,m", [(0.48, 238), (0.5, 234), (0.52, 238)])
def test_m_of_the_service_defaults_near_its_worst_case(s, m):
    """required_m(0.06, 0.06), the service's default m, is 238: the largest
    minimal m over the similarity grid, reached at s = 0.45, 0.48, 0.52 and
    0.55 and not at 0.5 (the binomial window is not monotone in m).  Scanning
    the whole grid takes 15 s, so only these values are computed here."""
    assert tau_ann.min_m_for_similarity(s, 0.06, 0.06) == m
    assert jtau.min_m_for_similarity(s, 0.06, 0.06) == m


@pytest.mark.parametrize("p", [1, 2])
def test_collision_probability_equals_reference(p):
    """A float32 closed form off the search path: 1e-6 absolute, the two
    libraries' erf/atan/log1p differ in the last bits."""
    dist = np.array([1e-3, 0.5, 1.0, 4.0, 16.0, 100.0], np.float32)
    got = e2lsh.collision_prob(torch.from_numpy(dist), 4.0, p).numpy()
    want = np.asarray(je2lsh.collision_prob(jnp.asarray(dist), 4.0, p))
    assert np.allclose(got, want, atol=1e-6, rtol=0)
    assert np.all(np.diff(got) < 0)                # strictly decreasing in distance
    with pytest.raises(ValueError):
        e2lsh.collision_prob(torch.from_numpy(dist), 4.0, 3)


def _bare_constructor_calls():
    """Every LSH parameter constructor of the port, called without a device."""
    from repro_torch.core.lsh import minhash, rbh, simhash

    gen = torch.Generator().manual_seed(0)
    z2, z1 = np.zeros((3, 2), np.float32), np.zeros(3, np.float32)
    return {
        "e2lsh.make": lambda: e2lsh.make(gen, d=2, m=3, w=4.0),
        "e2lsh.params_from_numpy": lambda: e2lsh.params_from_numpy(z2, z1, z1, 4.0, 2, 8),
        "simhash.make": lambda: simhash.make(gen, d=2, m=3),
        "simhash.params_from_numpy": lambda: simhash.params_from_numpy(z2),
        "minhash.make": lambda: minhash.make(gen, m=3),
        "minhash.params_from_numpy": lambda: minhash.params_from_numpy(z1, z1, 8),
        "rbh.make": lambda: rbh.make(gen, d=2, m=3, sigma=1.0),
        "rbh.params_from_numpy": lambda: rbh.params_from_numpy(z2, z2, z2, 1.0, 8),
        "rehash.make_seeds": lambda: rehash.make_seeds(gen, 3),
        "LshScheme.make_params": lambda: lsh.get_scheme("e2lsh").make_params(gen, d=2, m=3,
                                                                           w=4.0),
    }


@pytest.mark.parametrize("name", sorted(_bare_constructor_calls()))
def test_bare_constructor_targets_the_card_and_raises_without_one(name, monkeypatch):
    """The device rule (repro_torch.device.resolve_device): no device means the
    card, so where torch.cuda.is_available() is False a bare call raises
    instead of carrying on on the CPU; device="cpu" builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        _bare_constructor_calls()[name]()
