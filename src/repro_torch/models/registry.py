"""Uniform model API over the six architecture families.

The counterpart of `repro/models/registry.py`.  Every family exposes:

    init_params(cfg, key, device)                  -> params
    train_logits(cfg, params, batch)               -> (logits, aux, labels)
    prefill(cfg, params, batch, cache_cap)         -> (last_logits, cache, pos)
    decode_step(cfg, params, token, cache, pos)    -> (logits, cache)
    params_from_numpy(cfg, tree, device)           -> params (the reference's
                                                      weights carried across)

`batch` is a dict of tensors:
    dense / ssm / hybrid / moe : {"tokens": [B, S]}
    vlm   : {"patch_embeds": [B, P, D], "tokens": [B, S-P]}   (frontend stub)
    audio : {"frames": [B, S, D], "tokens": [B, S]}           (frontend stub)

Labels are next-token shifts of the text tokens (modality prefixes excluded
from the loss); `train_logits` is forward only -- the loss and its backward,
and the reference's `remat` switch, come with training.  configs/ registers
one ModelConfig per --arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.config import ModelConfig

IGNORE = -100  # label id excluded from the loss


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
    params_from_numpy: Callable  # (cfg, numpy tree, device) -> params
    supports_decode: bool = True
    sub_quadratic: bool = False


# --- dense / moe -----------------------------------------------------------

def _lm_train(cfg, params, batch):
    logits, aux, _ = transformer.forward(cfg, params, batch["tokens"])
    return logits, aux, _shift_labels(batch["tokens"])


def _lm_prefill(cfg, params, batch, cache_cap=None):
    return transformer.prefill(cfg, params, batch["tokens"], cache_cap=cache_cap)


_DENSE = ModelApi("dense", transformer.init_params, _lm_train, _lm_prefill,
                  transformer.decode_step, transformer.params_from_numpy)
_MOE = dataclasses.replace(_DENSE, family="moe")


# --- ssm -------------------------------------------------------------------

def _ssm_train(cfg, params, batch):
    logits, aux, _ = ssm.forward(cfg, params, batch["tokens"])
    return logits, aux, _shift_labels(batch["tokens"])


def _ssm_prefill(cfg, params, batch, cache_cap=None):
    return ssm.prefill(cfg, params, batch["tokens"])


_SSM = ModelApi("ssm", ssm.init_params, _ssm_train, _ssm_prefill, ssm.decode_step,
                ssm.params_from_numpy, sub_quadratic=True)


# --- hybrid ----------------------------------------------------------------

def _hyb_train(cfg, params, batch):
    logits, aux, _ = hybrid.forward(cfg, params, batch["tokens"])
    return logits, aux, _shift_labels(batch["tokens"])


def _hyb_prefill(cfg, params, batch, cache_cap=None):
    return hybrid.prefill(cfg, params, batch["tokens"], cache_cap=cache_cap)


_HYBRID = ModelApi("hybrid", hybrid.init_params, _hyb_train, _hyb_prefill,
                   hybrid.decode_step, hybrid.params_from_numpy, sub_quadratic=True)


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
                transformer.decode_step, transformer.params_from_numpy)


# --- audio (seamless enc-dec) ----------------------------------------------

def _audio_train(cfg, params, batch):
    logits, aux, _ = encdec.forward(cfg, params, batch["frames"], batch["tokens"])
    return logits, aux, _shift_labels(batch["tokens"])


def _audio_prefill(cfg, params, batch, cache_cap=None):
    return encdec.prefill(cfg, params, batch["frames"], batch["tokens"], cache_cap=cache_cap)


_AUDIO = ModelApi("audio", encdec.init_params, _audio_train, _audio_prefill,
                  encdec.decode_step, encdec.params_from_numpy)


_FAMILIES = {
    "dense": _DENSE,
    "moe": _MOE,
    "ssm": _SSM,
    "hybrid": _HYBRID,
    "vlm": _VLM,
    "audio": _AUDIO,
}

_CONFIGS: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _CONFIGS[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if not _CONFIGS:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    try:
        return _CONFIGS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIGS)}") from None


def get_api(cfg: ModelConfig) -> ModelApi:
    return _FAMILIES[cfg.family]


def list_archs() -> list[str]:
    if not _CONFIGS:
        import repro_torch.configs  # noqa: F401
    return sorted(_CONFIGS)
