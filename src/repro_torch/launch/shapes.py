"""Assigned input shapes and per-(arch, shape) tensor specs: the counterpart
of `repro/launch/shapes.py`, name for name.

    train_4k     seq=4096,   global_batch=256   (training)      -> train_step
    prefill_32k  seq=32768,  global_batch=32    (prefill)       -> prefill
    decode_32k   seq=32768,  global_batch=128   (decode)        -> decode_step
    long_500k    seq=524288, global_batch=1     (long decode)   -> decode_step,
                 sub-quadratic archs only (mamba2 / zamba2); pure full-attention
                 archs are recorded as skipped.

A spec is a tensor on the `meta` device: its shape and dtype, no storage
(the counterpart of `jax.ShapeDtypeStruct`).  `cache_specs` builds each
family's cache through the port's own `init_cache` on `meta`, so nothing is
allocated at any size.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def SDS(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A shape-and-dtype spec: an empty tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "full quadratic attention at 500k context (assignment rule: skip)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Batch specs for the full-sequence entry points (train_step /
    prefill)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        return {
            "patch_embeds": SDS((b, cfg.n_patches, cfg.d_model), torch.bfloat16),
            "tokens": SDS((b, s - cfg.n_patches), torch.int32),
        }
    if cfg.family == "audio":
        return {
            "frames": SDS((b, s, cfg.d_model), torch.bfloat16),
            "tokens": SDS((b, s), torch.int32),
        }
    return {"tokens": SDS((b, s), torch.int32)}


def token_specs(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    """Single decode-step token batch."""
    return SDS((shape.global_batch, 1), torch.int32)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """KV/state cache specs for decode cells (cap = seq_len)."""
    b, cap = shape.global_batch, shape.seq_len
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_cache(cfg, b, cap, device=META)
    if cfg.family == "ssm":
        return ssm.init_cache(cfg, b, device=META)
    if cfg.family == "hybrid":
        return hybrid.init_cache(cfg, b, cap, device=META)
    if cfg.family == "audio":
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        return {
            "k": SDS((cfg.n_layers, b, cap, kvh, hd), torch.bfloat16),
            "v": SDS((cfg.n_layers, b, cap, kvh, hd), torch.bfloat16),
            "memory": SDS((b, cap, cfg.d_model), torch.bfloat16),
        }
    raise ValueError(cfg.family)


def param_specs(cfg: ModelConfig, api=None):
    """The port's parameter tree at `cfg`'s size as meta tensors (the
    counterpart of `jax.eval_shape(init_params)`): the port's own
    `init_params` under `FakeTensorMode`, so no weight is drawn or
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.registry import get_api

    api = api or get_api(cfg)
    with FakeTensorMode():
        gen = torch.Generator(device="cpu").manual_seed(0)
        fake = api.init_params(cfg, gen)
    return _to_meta(fake)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(x) for x in tree]
    return SDS(tuple(tree.shape), tree.dtype)
