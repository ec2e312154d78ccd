"""Uniform model API over the ported architecture families.

The counterpart of `repro/models/registry.py` for the families that
`models/transformer.py` carries: dense, moe and vlm.  Every family exposes:

    init_params(cfg, key, device)                  -> params
    train_logits(cfg, params, batch)               -> (logits, aux, labels)
    prefill(cfg, params, batch, cache_cap)         -> (last_logits, cache, pos)
    decode_step(cfg, params, token, cache, pos)    -> (logits, cache)

`batch` is a dict of tensors:
    dense / moe : {"tokens": [B, S]}
    vlm         : {"patch_embeds": [B, P, D], "tokens": [B, S-P]}  (frontend stub)

Labels are next-token shifts of the text tokens (modality prefixes excluded
from the loss); `train_logits` is forward only -- the loss and its backward,
and the reference's `remat` switch, come with training.  configs/ registers one ModelConfig per --arch id.  The
ssm, hybrid and audio families are not ported yet: their arch ids raise
`KeyError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

IGNORE = -100  # label id excluded from the loss

# arch ids of the reference whose family is not ported yet
_UNPORTED = {
    "mamba2-1.3b": "ssm", "zamba2-2.7b": "hybrid", "seamless-m4t-large-v2": "audio",
}
_UNPORTED_ITEM = "ROADMAP.md queue 1 item 11b"


def _shift_labels(tokens: torch.Tensor) -> torch.Tensor:
    fill = torch.full((tokens.shape[0], 1), IGNORE, dtype=tokens.dtype, device=tokens.device)
    return torch.cat([tokens[:, 1:], fill], dim=1)


@dataclasses.dataclass(frozen=True)
class ModelApi:
    family: str
    init_params: Callable
    train_logits: Callable      # (cfg, params, batch) -> (logits, aux, labels)
    prefill: Callable           # (cfg, params, batch, cache_cap) -> (logits, cache, pos)
    decode_step: Callable       # (cfg, params, token, cache, pos) -> (logits, cache)
    supports_decode: bool = True
    sub_quadratic: bool = False


# --- dense / moe -----------------------------------------------------------

def _lm_train(cfg, params, batch):
    logits, aux, _ = transformer.forward(cfg, params, batch["tokens"])
    return logits, aux, _shift_labels(batch["tokens"])


def _lm_prefill(cfg, params, batch, cache_cap=None):
    return transformer.prefill(cfg, params, batch["tokens"], cache_cap=cache_cap)


_DENSE = ModelApi("dense", transformer.init_params, _lm_train, _lm_prefill,
                  transformer.decode_step)
_MOE = dataclasses.replace(_DENSE, family="moe")


# --- vlm (internvl2: patch-embedding prefix + dense LLM backbone) ----------

def _vlm_train(cfg, params, batch):
    logits, aux, _ = transformer.forward(
        cfg, params, batch["tokens"], embeds_prefix=batch["patch_embeds"])
    p = batch["patch_embeds"].shape[1]
    text_labels = _shift_labels(batch["tokens"])
    prefix = torch.full((text_labels.shape[0], p), IGNORE, dtype=text_labels.dtype,
                        device=text_labels.device)
    return logits, aux, torch.cat([prefix, text_labels], dim=1)


def _vlm_prefill(cfg, params, batch, cache_cap=None):
    return transformer.prefill(cfg, params, batch["tokens"], cache_cap=cache_cap,
                               embeds_prefix=batch["patch_embeds"])


_VLM = ModelApi("vlm", transformer.init_params, _vlm_train, _vlm_prefill,
                transformer.decode_step)


_FAMILIES = {
    "dense": _DENSE,
    "moe": _MOE,
    "vlm": _VLM,
}

_CONFIGS: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} of {cfg.arch_id!r} is not ported "
                         f"({_UNPORTED_ITEM})")
    _CONFIGS[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if not _CONFIGS:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    try:
        return _CONFIGS[arch_id]
    except KeyError:
        base = arch_id.removesuffix("-smoke")
        if base in _UNPORTED:
            raise KeyError(f"{arch_id!r} is of the {_UNPORTED[base]} family, which is not "
                           f"ported yet ({_UNPORTED_ITEM})") from None
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIGS)}") from None


def get_api(cfg: ModelConfig) -> ModelApi:
    return _FAMILIES[cfg.family]


def list_archs() -> list[str]:
    if not _CONFIGS:
        import repro_torch.configs  # noqa: F401
    return sorted(_CONFIGS)
