"""Batched serving engine: prefill + greedy/temperature decode over any
registered architecture, the KV cache written in place.

The counterpart of `repro/serve/engine.py`.  Design difference: sampling
draws from an explicit `torch.Generator` seeded with `seed` on the model's
device (`torch.multinomial` over the softmax of logits / temperature).  It
cannot equal `jax.random.categorical`'s draws for the same seed; the same
seed gives the same tokens, another seed other ones.  Greedy decoding
(`argmax`) is equal to the reference's.

Sharded serving: parameters placed on a mesh (`launch/sharding.
params_shardings(..., cfg.use_tp_serve)`, DTensor leaves) make `generate`
run under that mesh (`use_mesh`, DTensor's `implicit_replication`): the
batch is placed by `batch_shardings`, the cache prefill returns is placed by
`cache_shardings` (the reference's decode `in_shardings`), and each step's
logits are read whole to pick the next tokens.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import synchronize, tensor_from
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi


@dataclasses.dataclass
class ServeStats:
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    tokens_generated: int = 0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.decode_seconds, 1e-9)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, api: ModelApi, params, *, cache_cap: int = 512):
        self.cfg, self.api, self.params = cfg, api, params
        self.cache_cap = cache_cap
        self.device = params["embed"].device
        self.mesh = params["embed"].device_mesh if isinstance(params["embed"], DTensor) else None

    def _on_device(self, batch: dict) -> dict:
        batch = {k: tensor_from(v).to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return batch
        from repro_torch.launch import sharding

        placed = sharding.batch_shardings(batch, self.mesh, self.cfg.use_tp_serve)
        return {k: sharding.place(v, placed[k]) for k, v in batch.items()}

    def _place_cache(self, cache: dict) -> dict:
        if self.mesh is None:
            return cache
        from repro_torch.launch import sharding

        return sharding.place_tree(cache, sharding.cache_shardings(self.cfg, cache, self.mesh))

    def generate(self, batch: dict, max_new_tokens: int, *, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0) -> tuple[np.ndarray, ServeStats]:
        """batch: numpy arrays or tensors (`registry` says which keys);
        returns (tokens [B, max_new_tokens] int32 numpy, stats).  Durations
        are host time between two synchronises of the device."""
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        stats = ServeStats()
        if max_new_tokens == 0:
            # nothing to decode: empty [B, 0] output, zeroed stats, no prefill
            b = next(iter(batch.values())).shape[0]
            return np.zeros((b, 0), dtype=np.int32), stats
        with partition.sharded_scope(self.mesh):
            return self._generate(self._on_device(batch), max_new_tokens, greedy,
                                  temperature, seed, stats)

    def _generate(self, batch, max_new_tokens, greedy, temperature, seed, stats):
        # perf_counter, not time(): a wall-clock (NTP) step must never record
        # a negative or inflated prefill/decode duration
        synchronize(self.device)
        t0 = time.perf_counter()
        logits, cache, pos = self.api.prefill(self.cfg, self.params, batch,
                                              cache_cap=self.cache_cap)
        cache = self._place_cache(cache)
        synchronize(self.device)
        stats.prefill_seconds = time.perf_counter() - t0

        gen = None if greedy else torch.Generator(device=self.device).manual_seed(seed)
        outs = []
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            if isinstance(logits, DTensor):
                logits = logits.full_tensor()
            if greedy:
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
            outs.append(tok)
            logits, cache = self.api.decode_step(self.cfg, self.params, tok, cache, pos)
            pos = pos + 1
        synchronize(self.device)
        stats.decode_seconds = time.perf_counter() - t0
        stats.tokens_generated = max_new_tokens * outs[0].shape[0]
        return torch.cat(outs, dim=1).cpu().numpy(), stats
