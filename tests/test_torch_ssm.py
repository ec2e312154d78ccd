"""The port's SSD core (`repro_torch.models.ssm`) against the JAX package's
(`repro.models.ssm`) and the naive recurrence, on the same numpy inputs from
a seed (the shapes of tests/test_ssm.py).

Tolerance: 1e-4 on y and on the float32 state, as the reference's own test.
At g = 2 the group of head i is i // (h / g) (`jnp.repeat`); a port that
tiled the groups (`Tensor.repeat`: i % g) fails there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S

ATOL = 1e-4


def _inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.standard_normal((b, s, h)), jnp.float32)))
    A_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A_log, B, C


def _ssd_ref(x, dt, A_log, B, C):
    """The naive recurrence in float64 (tests/test_ssm.py's)."""
    b, s, h, p = x.shape
    hg = h // B.shape[2]
    state = np.zeros((b, h, B.shape[3], p))
    ys = np.zeros((b, s, h, p))
    a = -np.exp(A_log.astype(np.float64)) * dt.astype(np.float64)
    Bh = np.repeat(B.astype(np.float64), hg, axis=2)
    Ch = np.repeat(C.astype(np.float64), hg, axis=2)
    xd = x.astype(np.float64) * dt.astype(np.float64)[..., None]
    for t in range(s):
        state = state * np.exp(a[:, t])[..., None, None] \
            + Bh[:, t][..., None] * xd[:, t][:, :, None, :]
        ys[:, t] = np.einsum("bhn,bhnp->bhp", Ch[:, t], state)
    return ys, state


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_equals_reference_and_recurrence(chunk, g):
    args = _inputs(chunk * 10 + g, 2, 32, 4, 8, g, 16)
    y, state = S.ssd_chunked(*_t(*args), chunk=chunk)
    jy, jstate = JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ry, rstate = _ssd_ref(*args)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    assert tuple(state.shape) == (2, 4, 16, 8)
    assert _err(y, jy) < ATOL and _err(state, jstate) < ATOL
    assert _err(y, ry) < ATOL and _err(state, rstate) < ATOL


def test_group_to_head_map_is_repeat_interleave():
    """g = 2, h = 4: heads 0, 1 read group 0 and heads 2, 3 group 1.  With
    group 1's B and C zero, heads 2 and 3 see no input at all."""
    x, dt, A_log, B, C = _inputs(5, 1, 16, 4, 8, 2, 16)
    B[:, :, 1] = 0.0
    C[:, :, 1] = 0.0
    y, state = S.ssd_chunked(*_t(x, dt, A_log, B, C), chunk=8)
    assert float(y[:, :, 2:].abs().max()) == 0.0 and float(state[:, 2:].abs().max()) == 0.0
    assert float(y[:, :, :2].abs().max()) > 0.0
    jy, _ = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A_log, B, C)), chunk=8)
    assert _err(y, jy) < ATOL


def test_ssd_decode_continues_chunked_state():
    args = _inputs(7, 1, 24, 2, 4, 1, 8)
    x, dt, A_log, B, C = _t(*args)
    _, state = S.ssd_chunked(x[:, :16], dt[:, :16], A_log, B[:, :16], C[:, :16], chunk=8)
    jx, jdt, jA, jB, jC = map(jnp.asarray, args)
    _, jstate = JS.ssd_chunked(jx[:, :16], jdt[:, :16], jA, jB[:, :16], jC[:, :16], chunk=8)
    for t in range(16, 24):
        y, state = S.ssd_decode(x[:, t], dt[:, t], A_log, B[:, t], C[:, t], state)
        jy, jstate = JS.ssd_decode(jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], jstate)
        assert _err(y, jy) < ATOL and _err(state, jstate) < ATOL
    _, full = S.ssd_chunked(x, dt, A_log, B, C, chunk=8)
    ry, _ = _ssd_ref(*args)
    assert _err(state, full.numpy()) < ATOL
    assert _err(y, ry[:, -1]) < ATOL


def test_ssd_decode_at_bfloat16_keeps_a_float32_state():
    x, dt, A_log, B, C = _t(*_inputs(8, 2, 8, 4, 4, 2, 8))
    state = torch.zeros((2, 4, 8, 4))
    y, new = S.ssd_decode(x[:, 0].bfloat16(), dt[:, 0], A_log, B[:, 0].bfloat16(),
                          C[:, 0].bfloat16(), state)
    assert y.dtype == torch.bfloat16 and new.dtype == torch.float32
    yc, sc = S.ssd_chunked(x.bfloat16(), dt, A_log, B.bfloat16(), C.bfloat16(), chunk=4)
    assert yc.dtype == torch.bfloat16 and sc.dtype == torch.float32


def test_init_state_resume():
    """ssd_chunked(init_state=S) == continuing the same sequence, in both
    packages."""
    args = _inputs(9, 1, 32, 2, 4, 1, 8)
    x, dt, A_log, B, C = _t(*args)
    y_full, s_full = S.ssd_chunked(x, dt, A_log, B, C, chunk=8)
    _, s_half = S.ssd_chunked(x[:, :16], dt[:, :16], A_log, B[:, :16], C[:, :16], chunk=8)
    y2, s2 = S.ssd_chunked(x[:, 16:], dt[:, 16:], A_log, B[:, 16:], C[:, 16:], chunk=8,
                           init_state=s_half)
    assert _err(s2, s_full.numpy()) < ATOL and _err(y2, y_full[:, 16:].numpy()) < ATOL
    jx, jdt, jA, jB, jC = map(jnp.asarray, args)
    jy2, js2 = JS.ssd_chunked(jx[:, 16:], jdt[:, 16:], jA, jB[:, 16:], jC[:, 16:], chunk=8,
                              init_state=jnp.asarray(s_half.numpy()))
    assert _err(y2, jy2) < ATOL and _err(s2, js2) < ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_decode_and_reference(dtype):
    rng = np.random.default_rng(10)
    b, s, ch, w = 2, 10, 6, 4
    xbc = rng.standard_normal((b, s, ch)).astype(np.float32)
    wgt = (rng.standard_normal((w, ch)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(ch) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)
    txbc = torch.from_numpy(xbc).to(tdt)
    full = S.causal_conv(txbc, *_t(wgt, bias))
    assert full.dtype == tdt
    jfull = JS.causal_conv(jnp.asarray(xbc).astype(dtype), jnp.asarray(wgt), jnp.asarray(bias))
    assert _err(full.float(), np.asarray(jfull, np.float32)) < (ATOL if dtype == "float32"
                                                                else 2.0 ** -7)
    state = torch.zeros((b, w - 1, ch), dtype=tdt)
    for t in range(s):
        y, state = S.conv_decode(txbc[:, t], state, *_t(wgt, bias))
        assert y.dtype == tdt and state.dtype == tdt
        assert _err(y.float(), full[:, t].float().numpy()) < 1e-5
    assert torch.equal(state, txbc[:, -(w - 1):])            # the last W-1 inputs


def test_conv_decode_equals_reference_from_a_state():
    rng = np.random.default_rng(12)
    xbc = rng.standard_normal((3, 5)).astype(np.float32)
    state = rng.standard_normal((3, 3, 5)).astype(np.float32)
    wgt = rng.standard_normal((4, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    y, new = S.conv_decode(*_t(xbc, state, wgt, bias))
    jy, jnew = JS.conv_decode(*map(jnp.asarray, (xbc, state, wgt, bias)))
    assert _err(y, jy) < 1e-5 and _err(new, jnew) == 0.0


@pytest.mark.parametrize("s,chunk", [(12, 8), (7, 4), (33, 16)])
def test_both_packages_refuse_a_length_off_the_chunk(s, chunk):
    args = _inputs(13, 1, s, 2, 4, 1, 8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        S.ssd_chunked(*_t(*args), chunk=chunk)
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)


def test_a_prompt_off_the_chunk_is_refused_by_both_forwards():
    """The model level: a prompt that is not a whole number of SSD chunks
    (mamba2-1.3b-smoke: 8) is refused by the port's and the reference's
    prefill alike."""
    from repro.models.registry import get_api as jget_api, get_config as jget_config
    from repro_torch.models.registry import get_api, get_config

    cfg, jcfg = get_config("mamba2-1.3b-smoke"), jget_config("mamba2-1.3b-smoke")
    tokens = np.arange(2 * 12, dtype=np.int32).reshape(2, 12)
    params = get_api(cfg).init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        get_api(cfg).prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError):
        jget_api(jcfg).prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})


@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "zamba2-2.7b-smoke"])
def test_init_cache_shapes_and_dtypes_equal_reference(arch):
    from repro.models import hybrid as JH
    from repro.models.registry import get_config as jget_config
    from repro_torch.models import hybrid as H
    from repro_torch.models.registry import get_config

    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.family == "ssm":
        got, want = S.init_cache(cfg, 3, device="cpu"), JS.init_cache(jcfg, 3)
    else:
        got, want = H.init_cache(cfg, 3, 20, device="cpu"), JH.init_cache(jcfg, 3, 20)
        assert H.n_invocations(cfg) == JH.n_invocations(jcfg)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(arr.dtype), name
        assert float(got[name].abs().max()) == 0.0
    assert S.conv_channels(cfg) == JS.conv_channels(jcfg)
