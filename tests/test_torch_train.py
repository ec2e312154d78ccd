"""The port's training step (`repro_torch.train.step`) against the JAX
package's: the cross-entropy, the loss and every gradient leaf of one smoke
config per family through `jax.value_and_grad` of the reference's loss,
microbatch accumulation, `remat` (bit-equal gradients), one step on every
smoke arch, and the reference's own training tests.

Tolerances are the LM scope's: float32 1e-4, bfloat16 5e-2 (at the loss).
Weights are the reference's, carried across with `params_from_numpy`, with
the inert leaves moved by seeded noise (`test_torch_models.perturb_inert`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models.registry import get_api as jget_api, get_config as jget_config
from repro.optim import adamw as jadamw
from repro.train import step as jtsl
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import layers as L
from repro_torch.models.registry import IGNORE, get_api, get_config
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import step as tsl
from repro_torch.tree import leaves, unflatten
from test_torch_models import PORTED, reference_tree

FAMILIES = ["smollm-360m-smoke", "qwen2-moe-a2.7b-smoke", "mamba2-1.3b-smoke",
            "zamba2-2.7b-smoke", "internvl2-76b-smoke", "seamless-m4t-large-v2-smoke"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many small operations: one intra-op thread keeps
    them fast beside the other test workers (pytest-xdist), where a thread
    pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(arch, batch=2, seq=16, step=0):
    return JSyntheticTokens(jget_config(arch), JDataConfig(global_batch=batch,
                                                           seq_len=seq)).batch(step)


def _port(arch, dtype, tree, **hp_kw):
    cfg = dataclasses.replace(get_config(arch), compute_dtype=dtype)
    api = get_api(cfg)
    params = api.params_from_numpy(cfg, tree, device="cpu")
    hp = tsl.TrainHParams(**{"remat": False, **hp_kw})
    return cfg, api, tsl.state_from_params(params, hp), hp


def _port_loss_and_grads(cfg, api, params, batch, hp):
    loss, metrics = tsl.make_loss_fn(cfg, api, hp)(params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.detach(), metrics, unflatten(params, list(grads))


def _compare_trees(got, want, atol, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _compare_trees(got[k], want[k], atol, f"{what}/{k}")
        return
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float32) - want).max(initial=0.0))
    assert err <= atol, (what, err)


def test_cross_entropy_equals_the_reference_with_ignored_labels():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = IGNORE
    labels[2, -1] = IGNORE
    jce, jden = jtsl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    t = _t(logits).requires_grad_(True)
    ce, den = tsl.cross_entropy(t, _t(labels))
    assert float(den) == float(jden) == 17.0
    assert abs(float(ce.detach()) - float(jce)) <= 1e-6
    jg = jax.grad(lambda x: jtsl.cross_entropy(x, jnp.asarray(labels))[0])(jnp.asarray(logits))
    (g,) = torch.autograd.grad(ce, t)
    assert float(np.abs(g.numpy() - np.asarray(jg)).max()) <= 1e-7
    assert float(g[0, :3].abs().max()) == 0.0          # ignored positions get nothing
    all_ignored, den0 = tsl.cross_entropy(t.detach(), torch.full((3, 7), IGNORE))
    assert float(den0) == 1.0 and float(all_ignored) == 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_equal_the_reference(arch):
    """float32 compute: the loss, the aux and every gradient leaf (the
    port's per-layer gradients restacked by `params_to_numpy`) within
    1e-4 of `jax.value_and_grad` of the reference's loss; bfloat16 compute:
    the loss within 5e-2."""
    tree = reference_tree(arch)
    batch = _batch(arch)
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    japi = jget_api(jcfg)
    jhp = jtsl.TrainHParams(remat=False)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jtsl.make_loss_fn(jcfg, japi, jhp), has_aux=True))(tree, batch)

    cfg, api, state, hp = _port(arch, "float32", tree)
    loss, met, grads = _port_loss_and_grads(cfg, api, state.params, batch, hp)
    assert abs(float(loss) - float(jloss)) <= 1e-4
    assert abs(float(met["aux"].detach()) - float(jmet["aux"])) <= 1e-4
    assert float(met["tokens"]) == float(jmet["tokens"])
    _compare_trees(api.params_to_numpy(cfg, grads),
                   jax.tree_util.tree_map(np.asarray, jgrads), 1e-4, arch)

    jcfg16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jloss16 = jax.jit(lambda w, b: jtsl.make_loss_fn(jcfg16, jget_api(jcfg16), jhp)(w, b)[0]) \
        .lower(tree, batch).compile({"xla_allow_excess_precision": False})(tree, batch)
    cfg16, api16, state16, _ = _port(arch, "bfloat16", tree)
    loss16, _, _ = _port_loss_and_grads(cfg16, api16, state16.params, batch, hp)
    assert abs(float(loss16) - float(jloss16)) <= 5e-2


def _m_tree(arch, tree, batch, dtype, **hp_kw):
    """One port step; the first moment it leaves, as the reference's tree
    (with the clip off it is (1 - b1) x the step's gradient)."""
    cfg, api, state, hp = _port(arch, dtype, tree, optimizer=AdamWConfig(lr=1e-3, clip_norm=1e9),
                                warmup_steps=2, total_steps=10, **hp_kw)
    state, met = tsl.make_train_step(cfg, api, hp)(state, batch)
    return api.params_to_numpy(cfg, state.opt.m), met


def test_accumulation_equals_the_reference():
    """accum=2 on the MoE smoke config (its aux in the loss): one step's
    metrics and first moment (0.1 x the mean gradient of the two
    microbatches) against the reference's accum=2 step on the same batch."""
    arch = "qwen2-moe-a2.7b-smoke"
    tree = reference_tree(arch)
    batch = _batch(arch, batch=4)
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    jhp = jtsl.TrainHParams(optimizer=jadamw.AdamWConfig(lr=1e-3, clip_norm=1e9), accum=2,
                            remat=False, warmup_steps=2, total_steps=10)
    jstate = jtsl.TrainState(params=jax.tree_util.tree_map(jnp.asarray, tree),
                             opt=jadamw.init(tree, jhp.optimizer), compress_error=None)
    jstate, jmet = jax.jit(jtsl.make_train_step(jcfg, jget_api(jcfg), jhp))(jstate, batch)
    m, met = _m_tree(arch, tree, batch, "float32", accum=2)
    for k in ("loss", "aux", "tokens", "grad_norm", "lr"):
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-4 * max(1.0, abs(float(jmet[k]))), k
    assert int(met["step"]) == int(jmet["step"]) == 1
    _compare_trees(m, jax.tree_util.tree_map(np.asarray, jstate.opt.m), 1e-5, "m, accum 2")


def test_grad_accumulation_equivalent():
    """The reference's test on the port: accum=2 over a batch == accum=1
    over the same batch (the same gradients within 5e-3, at the config's
    bfloat16 compute)."""
    arch = "smollm-360m-smoke"
    tree = reference_tree(arch)
    batch = _batch(arch, batch=4, seq=64)
    dtype = get_config(arch).compute_dtype
    m1, _ = _m_tree(arch, tree, batch, dtype, accum=1)
    m2, _ = _m_tree(arch, tree, batch, dtype, accum=2)
    _compare_trees(jax.tree_util.tree_map(lambda m: m / 0.1, m1),
                   jax.tree_util.tree_map(lambda m: m / 0.1, m2), 5e-3, "accum 1 vs 2")


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_are_bit_equal_across_remat(arch):
    """Recomputation changes no number: the gradients with remat "none",
    "nothing" (and True) and "dots" are equal bit for bit, at bfloat16."""
    tree = reference_tree(arch)
    batch = _batch(arch)
    out = {}
    for remat in ("none", "nothing", True, "dots"):
        cfg, api, state, hp = _port(arch, "bfloat16", tree, remat=remat)
        loss, _, grads = _port_loss_and_grads(cfg, api, state.params, batch, hp)
        out[remat] = [loss] + leaves(grads)
    for remat in ("nothing", True, "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat], strict=True)), \
            (arch, remat)


def test_chunked_attention_checkpoints_each_query_chunk_and_equals_full_attention():
    """At S = 2048 (the chunked path): forward and gradients equal the full
    attention's within float32 rounding; the backward recomputes each query
    chunk (the saved tensors of the graph hold no score tile)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2048, 2, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 2048, 1, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 2048, 1, 8, generator=g, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = L.chunked_attention(q, k, v, causal=True)
    assert max(saved) < 512 * 1024          # no [Cq, Ck] float32 score tile is kept
    want = L.full_attention(q, k, v, causal=True)
    assert float((out - want).detach().abs().max()) <= 1e-5
    w = torch.randn(out.shape, generator=g)
    got_g = torch.autograd.grad((out * w).sum(), (q, k, v))
    want_g = torch.autograd.grad((want * w).sum(), (q, k, v))
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-4


def test_remat_refuses_an_unknown_setting():
    with pytest.raises(ValueError, match="remat"):
        L.remat_wrap(lambda h: h, "everything")


@pytest.mark.parametrize("arch", PORTED)
def test_one_train_step_on_every_smoke_arch(arch):
    cfg = get_config(arch)
    api = get_api(cfg)
    hp = tsl.TrainHParams(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1, total_steps=10)
    state = tsl.init_state(cfg, api, 0, hp, device="cpu")
    batch = SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=16)).batch(0)
    before = [p.detach().clone() for p in leaves(state.params)]
    step = tsl.make_train_step(cfg, api, hp)
    state, met = step(state, batch)
    assert np.isfinite(float(met["loss"])) and np.isfinite(float(met["grad_norm"]))
    assert float(met["grad_norm"]) > 0 and int(met["step"]) == 1
    assert float(met["lr"]) == 0.0                      # warmup starts at 0, as the reference's
    assert any(float(m.abs().max()) > 0 for m in leaves(state.opt.m))
    state, met = step(state, batch)
    assert float(met["lr"]) == pytest.approx(1e-3) and np.isfinite(float(met["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(state.params)))


def test_loss_decreases():
    """The reference's test_loss_decreases on the port."""
    cfg = get_config("smollm-360m-smoke")
    api = get_api(cfg)
    hp = tsl.TrainHParams(optimizer=AdamWConfig(lr=2e-3), total_steps=50, warmup_steps=5)
    state = tsl.init_state(cfg, api, 0, hp, device="cpu")
    pipe = SyntheticTokens(cfg, DataConfig(global_batch=4, seq_len=64))
    step = tsl.make_train_step(cfg, api, hp)
    losses = []
    for i in range(30):
        state, m = step(state, pipe.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_moe_aux_loss_is_at_least_one():
    """The router aux loss is >= 1 (balanced == 1) and finite."""
    cfg = get_config("qwen2-moe-a2.7b-smoke")
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    batch = SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=32)).batch(0)
    _, aux, _ = api.train_logits(cfg, params, {k: _t(v) for k, v in batch.items()},
                                 remat=False)
    assert float(aux) >= 0.99
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_builds_no_graph_while_training_does(arch):
    """With parameters that require grad: prefill, decode_step and
    ServeEngine.generate return tensors with no autograd history, while
    train_logits' logits carry a graph back to the parameters."""
    cfg = get_config(arch)
    api = get_api(cfg)
    state = tsl.init_state(cfg, api, 0, tsl.TrainHParams(), device="cpu")
    params = state.params
    assert all(p.requires_grad for p in leaves(params))
    batch = {k: _t(v) for k, v in
             SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=16)).batch(0).items()}
    logits, aux, _ = api.train_logits(cfg, params, batch)
    assert logits.requires_grad and logits.grad_fn is not None
    last, cache, pos = api.prefill(cfg, params, batch, cache_cap=24)
    assert not last.requires_grad and last.grad_fn is None
    assert not any(t.requires_grad for t in leaves(cache))
    tok = torch.argmax(last, -1)[:, None].to(torch.int32)
    step, cache = api.decode_step(cfg, params, tok, cache, pos)
    assert not step.requires_grad and step.grad_fn is None
    assert not any(t.requires_grad for t in leaves(cache))
    toks, stats = ServeEngine(cfg, api, params, cache_cap=24).generate(
        {k: v.numpy() for k, v in batch.items()}, max_new_tokens=2)
    assert toks.shape == (2, 2) and stats.tokens_generated == 4


def test_remat_accepts_the_launcher_strings():
    for remat in (True, False, "nothing", "dots", "none"):
        assert tsl.TrainHParams(remat=remat).remat == remat
