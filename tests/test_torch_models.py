"""The port's LM serving path (`repro_torch.models.*`, all six families)
against the JAX package's on the reference's own weights, carried across
with each family's `params_from_numpy`.

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
within 0.033 of the latter.

The reference initialises some leaves to constants that make a block inert
or symmetric (zero LoRA `b_q`, conv and qkv biases; unit norms and
`D_skip`; fixed `A_log` and `dt_bias`): with them, a port that dropped the
LoRA, the conv bias or the D skip would still agree.  `reference_tree`
replaces those leaves with seeded noise before both packages see them."""
import dataclasses
import inspect

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

NEW_FAMILIES = ["mamba2-1.3b-smoke", "zamba2-2.7b-smoke", "seamless-m4t-large-v2-smoke"]
PORTED = ["phi3-mini-3.8b-smoke", "mistral-large-123b-smoke", "qwen2.5-14b-smoke",
          "smollm-360m-smoke", "qwen2-moe-a2.7b-smoke", "grok-1-314b-smoke",
          "internvl2-76b-smoke"] + NEW_FAMILIES
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


# leaf name -> (scale of the seeded noise added to it); the norms' names
# start with "ln" or end in "_ln" / "norm"
_INERT = {"b_q": 0.06, "conv_b": 0.1, "bq": 0.1, "bk": 0.1, "bv": 0.1, "D_skip": 0.5,
          "A_log": 0.3, "dt_bias": 0.3}
_NORM_NOISE = 0.2


def perturb_inert(tree, seed: int = 11):
    """The numpy tree with every inert leaf (`_INERT`, the norms) moved by
    seeded noise, in the order of a sorted walk."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        scale = _INERT.get(name)
        if scale is None and (name.startswith("ln") or name.endswith(("_ln", "norm"))):
            scale = _NORM_NOISE
        if scale is None:
            return node
        noise = rng.standard_normal(node.shape) * scale
        return (np.asarray(node, np.float32) + noise).astype(node.dtype)

    return walk(tree)


def reference_tree(arch):
    cfg = jget_config(arch)
    init = jax.jit(jget_api(cfg).init_params, static_argnums=0)
    return perturb_inert(jax.tree_util.tree_map(np.asarray, init(cfg, jax.random.PRNGKey(0))))


def _strict(fn, *args):
    """fn(*args) compiled with every bfloat16 intermediate rounded."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("arch", PORTED)
def test_logits_prefill_and_decode_equal_reference(arch):
    """At float32 compute (bfloat16: tests/test_torch_models_bf16.py)."""
    hold_arch(arch, "float32")


def _close_cache(cache, jcache, atol, what):
    """Every cache entry of the reference at its dtype (the KV caches are
    bfloat16, the SSM state float32, conv tails and encoder memory the
    compute dtype): one bfloat16 step above atol where it is bfloat16."""
    assert sorted(cache) == sorted(jcache), (what, sorted(cache))
    for name, want in jcache.items():
        got = cache[name]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (what, name)
        rtol = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
        _close(got, want, atol, rtol, what=f"{what} {name}")


def hold_arch(arch, dtype):
    tree = reference_tree(arch)
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch), compute_dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    japi, api = jget_api(jcfg), get_api(cfg)
    params = api.params_from_numpy(cfg, tree, device="cpu")
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
    _close_cache(cache, jcache, atol, "cache")

    token = np.asarray(jnp.argmax(jlast, -1)[:, None].astype(jnp.int32))
    jstep, jcache2 = _strict(lambda w, t, c, p: japi.decode_step(jcfg, w, t, c, p),
                             tree, jnp.asarray(token), jcache, jpos)
    step, cache2 = api.decode_step(cfg, params, _t(token), cache, pos)
    assert cache2 is cache                                  # written in place
    _close(step, jstep, atol, what="decode logits")
    _close_cache(cache2, jcache2, atol, "decoded cache")


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
    """Every arch id of the reference, with its family and flags; an unknown
    id raises `KeyError` naming the known ones."""
    assert ALL_ARCHS == J_ALL_ARCHS
    assert registry.list_archs() == jlist_archs()
    assert len(registry.list_archs()) == 20
    assert registry.list_archs() == sorted(ALL_ARCHS + [a + "-smoke" for a in ALL_ARCHS])
    for arch in registry.list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        api, japi = get_api(cfg), jget_api(jcfg)
        assert api.family == japi.family == cfg.family, arch
        assert (api.sub_quadratic, api.supports_decode) == \
            (japi.sub_quadratic, japi.supports_decode), arch
    assert {get_api(get_config(a)).family for a in ALL_ARCHS} == \
        {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_port_init_has_the_reference_shapes():
    """The port draws its own weights (torch.Generator); shapes, dtypes and
    the unstacked layer axis follow the reference's."""
    for arch in ("qwen2-moe-a2.7b-smoke", "internvl2-76b-smoke", "smollm-360m-smoke",
                 *NEW_FAMILIES):
        cfg, jcfg = get_config(arch), jget_config(arch)
        api = get_api(cfg)
        params = api.init_params(cfg, 0, device="cpu")
        shapes = jax.eval_shape(lambda: jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
        want = api.params_from_numpy(
            cfg, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
        got_leaves = jax.tree_util.tree_leaves_with_path(params)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert g.shape == w.shape and g.dtype == w.dtype, path
        again = api.init_params(cfg, 0, device="cpu")
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_rope", [True, False])
@pytest.mark.parametrize("long_chunked,s", [(True, 16), (True, 2048), (False, 2048)])
def test_attention_block_keywords_equal_reference(causal, use_rope, long_chunked, s):
    """attention_block takes the reference's keyword set, and its self-attention
    path at each `causal` / `use_rope` / `long_chunked` equals the reference's
    (chunked from 2048 positions unless long_chunked is off)."""
    assert list(inspect.signature(L.attention_block).parameters) == \
        list(inspect.signature(JL.attention_block).parameters)
    kw = dict(arch_id="t", family="dense", n_layers=1, d_model=16, n_heads=4, n_kv_heads=2,
              d_ff=32, vocab=32, compute_dtype="float32")
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = jax.tree_util.tree_map(np.asarray, JL.init_attention(
        jax.random.PRNGKey(2), jcfg, jnp.float32, 0.5))
    x = np.random.default_rng(3).standard_normal((1, s, 16)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (1, s))
    flags = dict(causal=causal, use_rope=use_rope, long_chunked=long_chunked)
    want, (jk, jv) = JL.attention_block(jnp.asarray(x), p, jcfg, jnp.asarray(positions),
                                        **flags)
    got, (k, v) = L.attention_block(_t(x), jax.tree_util.tree_map(_t, p), cfg,
                                    _t(positions), **flags)
    _close(got, want, 1e-5, what="attention")
    _close(k, jk, 1e-5, what="emitted k")
    _close(v, jv, 1e-6, what="emitted v")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_decode_matches_forward(arch):
    """The port's counterpart of tests/test_models.py's check, at the shipped
    bfloat16 compute on the port's own weights: prefill + one decode step ==
    a teacher-forced forward at that position (padded to a whole SSD chunk;
    the encoder-decoder sees the same frames)."""
    from repro_torch.data.pipeline import DataConfig as TDataConfig
    from repro_torch.data.pipeline import SyntheticTokens as TSyntheticTokens

    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    batch = _batch_tensors(TSyntheticTokens(cfg, TDataConfig(global_batch=2, seq_len=16))
                           .batch(0))
    last, cache, pos = api.prefill(cfg, params, batch, cache_cap=32)
    nt = torch.argmax(last, -1)[:, None].to(torch.int32)
    step, _ = api.decode_step(cfg, params, nt, cache, pos)
    pad = torch.zeros((2, 7), dtype=torch.int32)          # pad to an SSD-chunk multiple
    full, _, _ = api.train_logits(cfg, params,
                                  dict(batch, tokens=torch.cat([batch["tokens"], nt, pad], 1)))
    err = float((step - full[:, pos]).abs().max())
    assert err < 5e-2, (arch, err)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_chip_smoke_decode_vs_forward_pads_and_passes_frames(arch):
    """chip_smoke.py's decode_vs_forward (phase 6f) on the SSM, hybrid and
    encoder-decoder families: the forward is padded to a whole SSD chunk and
    the encoder-decoder's frames are passed on."""
    import chip_smoke

    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    batch = SyntheticTokens(jget_config(arch), DataConfig(global_batch=2, seq_len=16)).batch(0)
    res = chip_smoke.decode_vs_forward(api, cfg, params, _t(batch["tokens"]), cache_cap=24,
                                       frames=_t(batch["frames"]) if "frames" in batch else None)
    assert len(res["err"]) == 2 and max(res["err"]) < 5e-2
    assert res["prompt_flips"] == [0, 0] and res["new_flips"] == [0, 0]


def test_chip_smoke_float32_kv_prefill_is_tied_to_the_shipped_prefill():
    """chip_smoke.py holds zamba2's decode step on a prefill that keeps the
    shared-attention K/V in float32 (`prefill_float32_kv`); the phase holds
    that prefill to the shipped `hybrid.prefill` bit for bit (K/V once
    rounded to bfloat16), and a cache that differs is refused."""
    import chip_smoke

    arch = "zamba2-2.7b-smoke"
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    tokens = _t(SyntheticTokens(jget_config(arch), DataConfig(global_batch=2, seq_len=16))
                .batch(0)["tokens"])
    got = chip_smoke.prefill_float32_kv(cfg, params, {"tokens": tokens}, cache_cap=24)
    assert got[1]["attn_k"].dtype == torch.float32
    chip_smoke.check_float32_kv_prefill(cfg, params, {"tokens": tokens}, 24, got)
    res = chip_smoke.decode_vs_forward(api, cfg, params, tokens, cache_cap=24, float32_kv=True)
    assert max(res["err"]) < 5e-2
    for name in ("attn_v", "ssm"):
        last, cache, pos = chip_smoke.prefill_float32_kv(cfg, params, {"tokens": tokens}, 24)
        cache[name].view(-1)[7] += 0.5
        with pytest.raises(RuntimeError, match=name):
            chip_smoke.check_float32_kv_prefill(cfg, params, {"tokens": tokens}, 24,
                                                (last, cache, pos))
