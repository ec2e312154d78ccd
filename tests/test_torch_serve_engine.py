"""The port's LM serving engine (`repro_torch.serve.ServeEngine`) against the
JAX package's: greedy tokens equal at float32 compute on the reference's
weights (the audio family's batch carries float32 `frames`), the zero-token and negative-count contracts, and seeded sampling
(a design difference: `torch.Generator`, not `jax.random.categorical`)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.models.registry import get_api as jget_api, get_config as jget_config
from repro.serve import ServeEngine as JServeEngine
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import ServeEngine, ServeStats


def _engines(arch, cache_cap=48):
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if cfg.family == "moe":  # capacity dropping is population-dependent
        jcfg = dataclasses.replace(jcfg, capacity_factor=64.0)
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    init = jax.jit(jget_api(jcfg).init_params, static_argnums=0)
    tree = jax.tree_util.tree_map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))
    jeng = JServeEngine(jcfg, jget_api(jcfg), tree, cache_cap=cache_cap)
    eng = ServeEngine(cfg, get_api(cfg), get_api(cfg).params_from_numpy(cfg, tree, "cpu"),
                      cache_cap=cache_cap)
    return jcfg, jeng, eng


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b-smoke", "qwen2-moe-a2.7b-smoke",
                                  "internvl2-76b-smoke", "mamba2-1.3b-smoke",
                                  "zamba2-2.7b-smoke", "seamless-m4t-large-v2-smoke"])
def test_greedy_tokens_equal_reference_at_float32(arch):
    jcfg, jeng, eng = _engines(arch)
    batch = SyntheticTokens(jcfg, DataConfig(global_batch=3, seq_len=16)).batch(0)
    want, _ = jeng.generate(batch, max_new_tokens=8)
    got, stats = eng.generate(batch, max_new_tokens=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    assert np.array_equal(got, want)
    assert stats.tokens_generated == 24
    assert stats.prefill_seconds > 0 and stats.decode_seconds > 0
    assert stats.decode_tokens_per_s > 0
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    again, _ = eng.generate(tensors, max_new_tokens=8)
    assert np.array_equal(again, want)


def test_zero_new_tokens_and_negative_count():
    _, _, eng = _engines("phi3-mini-3.8b-smoke")
    batch = SyntheticTokens(get_config("phi3-mini-3.8b-smoke"),
                            DataConfig(global_batch=3, seq_len=16)).batch(0)
    toks, stats = eng.generate(batch, max_new_tokens=0)
    assert toks.shape == (3, 0) and toks.dtype == np.int32
    assert stats == ServeStats()
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate(batch, max_new_tokens=-1)


def test_sampling_is_seeded_by_a_torch_generator():
    _, _, eng = _engines("phi3-mini-3.8b-smoke")
    batch = SyntheticTokens(get_config("phi3-mini-3.8b-smoke"),
                            DataConfig(global_batch=2, seq_len=16)).batch(0)
    a, _ = eng.generate(batch, max_new_tokens=12, greedy=False, temperature=2.0, seed=0)
    a2, _ = eng.generate(batch, max_new_tokens=12, greedy=False, temperature=2.0, seed=0)
    b, _ = eng.generate(batch, max_new_tokens=12, greedy=False, temperature=2.0, seed=1)
    assert np.array_equal(a, a2)
    assert not np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 512


@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "zamba2-2.7b-smoke",
                                  "seamless-m4t-large-v2-smoke"])
def test_launch_serve_accepts_every_family(arch, capsys):
    """`--arch` takes the ssm, hybrid and audio ids, and retrieval through
    their embedding tables finds each query's own document."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--n-docs", "500", "--n-queries",
                      "32", "--batches", "1"])
    assert "top-1 self-retrieval" in capsys.readouterr().out
    assert out["self_retrieval"] > 0.9
