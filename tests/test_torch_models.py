"""The port's LM serving path (`repro_torch.models.*`, the dense, moe and vlm
families) against the JAX package's on the reference's own weights, carried
across with `transformer.params_from_numpy`.

Tolerances: logits within atol 1e-4 at float32 compute and 5e-2 at the
shipped bfloat16 (the reference's own decode-vs-forward bound).  The KV cache
is bfloat16 in both packages whatever the compute dtype, so it is compared
at that dtype's resolution (one bfloat16 step, rtol 2**-7) above the same
atol.  Parameter counts are integers and must be equal.

The reference is compiled with `xla_allow_excess_precision` off, so that
each bfloat16 operation rounds to its declared dtype, as PyTorch's do (and as
the reference's own op-by-op evaluation does).  With it on, XLA's CPU
program keeps bfloat16 intermediates in float32 inside its fusions, and on
grok-1-314b-smoke that moves the reference's own train logits by 1.35 from
its op-by-op evaluation (two tokens' routing changes), where the port stays
within 0.033 of the latter."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_api as jget_api, get_config as jget_config
from repro.models.registry import list_archs as jlist_archs
from repro_torch.configs import ALL_ARCHS
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import registry, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_api, get_config

PORTED = ["phi3-mini-3.8b-smoke", "mistral-large-123b-smoke", "qwen2.5-14b-smoke",
          "smollm-360m-smoke", "qwen2-moe-a2.7b-smoke", "grok-1-314b-smoke",
          "internvl2-76b-smoke"]
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
BF16_STEP = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - rtol * np.abs(want)
    assert float(err.max(initial=0.0)) <= atol, (what, float(np.abs(got - want).max()))


def _batch_tensors(batch):
    return {k: _t(v) for k, v in batch.items()}


def reference_tree(arch):
    cfg = jget_config(arch)
    init = jax.jit(jget_api(cfg).init_params, static_argnums=0)
    return jax.tree_util.tree_map(np.asarray, init(cfg, jax.random.PRNGKey(0)))


def _strict(fn, *args):
    """fn(*args) compiled with every bfloat16 intermediate rounded."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("arch", PORTED)
def test_logits_prefill_and_decode_equal_reference(arch):
    """At float32 compute (bfloat16: tests/test_torch_models_bf16.py)."""
    hold_arch(arch, "float32")


def hold_arch(arch, dtype):
    tree = reference_tree(arch)
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch), compute_dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi, api = jget_api(jcfg), get_api(cfg)
    params = transformer.params_from_numpy(cfg, tree, device="cpu")
    batch = SyntheticTokens(jcfg, DataConfig(global_batch=2, seq_len=16)).batch(0)
    tbatch = _batch_tensors(batch)
    atol = ATOL[dtype]

    jlogits, jaux, jlabels = _strict(
        lambda w, b: japi.train_logits(jcfg, w, b, remat=False), tree, batch)
    logits, aux, labels = api.train_logits(cfg, params, tbatch)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, atol, what="train logits")
    _close(aux, jaux, atol, what="aux")
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))

    jlast, jcache, jpos = _strict(lambda w, b: japi.prefill(jcfg, w, b, cache_cap=24),
                                  tree, batch)
    last, cache, pos = api.prefill(cfg, params, tbatch, cache_cap=24)
    assert pos == int(jpos)
    _close(last, jlast, atol, what="prefill logits")
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        _close(cache[name], jcache[name], atol, BF16_STEP, what=f"cache {name}")

    token = np.asarray(jnp.argmax(jlast, -1)[:, None].astype(jnp.int32))
    jstep, jcache2 = _strict(lambda w, t, c, p: japi.decode_step(jcfg, w, t, c, p),
                             tree, jnp.asarray(token), jcache, jpos)
    step, cache2 = api.decode_step(cfg, params, _t(token), cache, pos)
    assert cache2 is cache                                  # written in place
    _close(step, jstep, atol, what="decode logits")
    for name in ("k", "v"):
        _close(cache2[name], jcache2[name], atol, BF16_STEP, what=f"decoded cache {name}")


def _moe_cfg(**kw):
    base = dict(arch_id="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=0, vocab=32, n_experts=4, experts_top_k=2,
                moe_d_ff=24, shared_expert_d_ff=20, capacity_factor=0.5,
                compute_dtype="float32")
    base.update(kw)
    return base


@pytest.mark.parametrize("shared", [0, 20])
@pytest.mark.parametrize("factor", [0.5, 64.0])
def test_moe_ffn_equals_reference_with_and_without_drops(shared, factor):
    kw = _moe_cfg(shared_expert_d_ff=shared, capacity_factor=factor)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: JM.init_moe(key, jcfg, jnp.float32, 0.5))(jax.random.PRNGKey(4)))
    x = np.random.default_rng(5).standard_normal((2, 24, 16)).astype(np.float32)
    # the router's picks must not hang on a tie: the (k)th and (k+1)th
    # probabilities of every token differ
    probs = np.asarray(jax.nn.softmax(x.reshape(-1, 16) @ p["router"], axis=-1))
    ranked = np.sort(probs, axis=-1)[:, ::-1]
    assert np.all(ranked[:, 1] - ranked[:, 2] > 1e-6)
    jy, jaux = jax.jit(lambda x, p: JM.moe_ffn(x, p, jcfg))(jnp.asarray(x), p)
    M.start_routing_record()
    y, aux = M.moe_ffn(_t(x), jax.tree_util.tree_map(_t, p), cfg)
    (top_e,) = M.stop_routing_record()
    assert M.stop_routing_record() == []                 # recording stopped
    _close(y, jy, 1e-4, what="moe y")
    _close(aux, jaux, 1e-4, what="moe aux")
    assert M.capacity(48, cfg) == JM.capacity(48, jcfg)
    # the recorded picks are the reference router's top 2, token-major
    assert np.array_equal(np.sort(top_e.numpy(), axis=-1),
                          np.sort(np.argsort(-probs, axis=-1)[:, :2], axis=-1))
    per_expert = np.bincount(top_e.numpy().ravel(), minlength=4)
    dropped = np.maximum(per_expert - M.capacity(48, cfg), 0).sum()
    assert (dropped > 0) == (factor < 1.0)


@pytest.mark.parametrize("tokens", [1, 7, 400, 4097, 100_000])
@pytest.mark.parametrize("factor", [0.5, 1.25, 64.0])
def test_capacity_keeps_the_reference_rounding(tokens, factor):
    kw = _moe_cfg(n_experts=60, experts_top_k=4, capacity_factor=factor)
    assert M.capacity(tokens, ModelConfig(**kw)) == JM.capacity(tokens, JModelConfig(**kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_and_full_attention_equal_reference(causal, softcap):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 4, 8)).astype(np.float32) * 3
    k = rng.standard_normal((2, 64, 2, 8)).astype(np.float32) * 3
    v = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    full = L.full_attention(_t(q), _t(k), _t(v), causal=causal, softcap=softcap)
    chunked = L.chunked_attention(_t(q), _t(k), _t(v), causal=causal, softcap=softcap,
                                  q_chunk=16, k_chunk=32)
    want = JL.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, softcap=softcap)
    _close(full, want, 1e-5, what="full")
    _close(chunked, full, 1e-5, what="chunked")
    _close(chunked, JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, softcap=softcap, q_chunk=16,
                                         k_chunk=32), 1e-5, what="reference chunked")
    scores = rng.standard_normal((3, 5)).astype(np.float32) * 100
    _close(L._soft_cap(_t(scores), softcap), JL._soft_cap(jnp.asarray(scores), softcap), 1e-4)


def test_param_counts_equal_reference_for_every_full_config():
    full = [a for a in jlist_archs() if not a.endswith("-smoke")]
    assert len(full) == 10
    for arch in full:
        jcfg = jget_config(arch)
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        assert (cfg.d_inner, cfg.ssm_n_heads) == (jcfg.d_inner, jcfg.ssm_n_heads), arch
        if arch in ALL_ARCHS:
            assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jcfg)


def test_registry_holds_the_ported_archs_and_names_the_rest():
    assert ALL_ARCHS == [a for a in J_ALL_ARCHS
                         if jget_config(a).family in ("dense", "moe", "vlm")]
    assert registry.list_archs() == sorted(ALL_ARCHS + [a + "-smoke" for a in ALL_ARCHS])
    for arch in ("mamba2-1.3b", "zamba2-2.7b-smoke", "seamless-m4t-large-v2"):
        with pytest.raises(KeyError, match="item 11b"):
            get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="not ported"):
        registry.register(ModelConfig(arch_id="x", family="ssm", n_layers=1, d_model=8,
                                      n_heads=0, n_kv_heads=0, d_ff=0, vocab=8))
    for arch in ALL_ARCHS:
        assert get_api(get_config(arch)).family == get_config(arch).family


def test_port_init_has_the_reference_shapes():
    """The port draws its own weights (torch.Generator); shapes, dtypes and
    the unstacked layer axis follow the reference's."""
    for arch in ("qwen2-moe-a2.7b-smoke", "internvl2-76b-smoke", "smollm-360m-smoke"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        params = transformer.init_params(cfg, 0, device="cpu")
        shapes = jax.eval_shape(lambda: jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
        want = transformer.params_from_numpy(
            cfg, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
        got_leaves = jax.tree_util.tree_leaves_with_path(params)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert g.shape == w.shape and g.dtype == w.dtype, path
        again = transformer.init_params(cfg, 0, device="cpu")
        assert torch.equal(again["embed"], params["embed"])


def test_routing_record_follows_prefill_and_decode():
    """The routing record that chip_smoke.py's phase 6d reads: one [T, k]
    entry a layer, token-major; prefill's and the decode step's picks equal
    a teacher-forced forward's at float32, and its drop count is the
    capacity arithmetic's."""
    import chip_smoke

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b-smoke"), compute_dtype="float32")
    api = get_api(cfg)
    params = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 12)))
    res = chip_smoke.decode_vs_forward(api, cfg, params, tokens, cache_cap=16)
    assert len(res["err"]) == 2 and max(res["err"]) < 5e-2
    assert res["prompt_flips"] == [0, 0] and res["new_flips"] == [0, 0]
    M.start_routing_record()
    last, cache, pos = api.prefill(cfg, params, {"tokens": tokens}, cache_cap=16)
    api.decode_step(cfg, params, torch.argmax(last, -1)[:, None], cache, pos)
    record = M.stop_routing_record()
    k = cfg.experts_top_k
    assert [tuple(t.shape) for t in record] == [(24, k)] * cfg.n_layers + [(2, k)] * cfg.n_layers
    dropped, slots = chip_smoke.moe_dropped(record[:1], cfg)
    per_expert = np.bincount(record[0].numpy().ravel(), minlength=cfg.n_experts)
    assert slots == 24 * k
    assert dropped == np.maximum(per_expert - M.capacity(24, cfg), 0).sum()


def test_cross_attention_over_kv_override_equals_reference():
    """attention_block's cross-attention path (`kv_override`, no rotary, the
    q bias only) against the reference's."""
    kw = dict(arch_id="t", family="dense", n_layers=1, d_model=16, n_heads=4, n_kv_heads=2,
              d_ff=32, vocab=32, qkv_bias=True, compute_dtype="float32")
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = jax.tree_util.tree_map(np.asarray, JL.init_attention(
        jax.random.PRNGKey(6), jcfg, jnp.float32, 0.5))
    p["bq"] = np.random.default_rng(8).standard_normal(p["bq"].shape).astype(np.float32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, cfg.head_dim)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, cfg.head_dim)).astype(np.float32)
    positions = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    want, _ = JL.attention_block(jnp.asarray(x), p, jcfg, jnp.asarray(positions),
                                 kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, emitted = L.attention_block(_t(x), jax.tree_util.tree_map(_t, p), cfg,
                                     _t(positions), kv_override=(_t(k), _t(v)))
    assert emitted is None
    _close(got, want, 1e-5, what="cross-attention")
