"""Which sharded paths of the port run on this installation's DTensor: each
smoke arch's sharded train step (use_tp True and False; phi3-mini also with
accum 2 and with gradient compression) against the same step unsharded, and
sharded serving (`ServeEngine` on placed parameters) against unsharded
serving, on a one-rank mesh.  DTensor's sharding rules differ between torch
releases, so one run lists every operation a release refuses, not only the
first.  Each case prints OK with its (sharded, plain) losses or tokens-equal
flag, or FAIL with the last lines of its traceback; the last line counts the
failures.

  PYTHONPATH=src python tools/dtensor_probe.py                 # on the card (NCCL)
  PYTHONPATH=src python tools/dtensor_probe.py --device cpu    # gloo, at once
"""
from __future__ import annotations

import argparse
import dataclasses
import traceback

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import ServeEngine
from repro_torch.train import step as tsl

ARCHS = ["smollm-360m-smoke", "phi3-mini-3.8b-smoke", "qwen2-moe-a2.7b-smoke",
         "internvl2-76b-smoke", "mamba2-1.3b-smoke", "zamba2-2.7b-smoke",
         "seamless-m4t-large-v2-smoke", "grok-1-314b-smoke"]
EXTRA = {"phi3-mini-3.8b-smoke": ({"accum": 2}, {"grad_compression": True})}


def _seq(cfg, plain: int) -> int:
    return plain if cfg.family not in ("ssm", "hybrid") else 2 * cfg.ssd_chunk


def train_case(arch: str, use_tp: bool, extra: dict, mesh, dev) -> tuple:
    cfg = dataclasses.replace(get_config(arch), use_tp=use_tp)
    api = get_api(cfg)
    hp = tsl.TrainHParams(remat="nothing", warmup_steps=1, total_steps=4, **extra)
    plain = tsl.state_from_params(api.init_params(cfg, 0, device=dev), hp)
    state = tsl.state_from_params(api.init_params(cfg, 0, device=dev), hp)
    psh = sh.params_shardings(state.params, mesh, use_tp)
    state = sh.place_tree(state, sh.state_shardings(state, psh, mesh))
    batch = SyntheticTokens(cfg, DataConfig(global_batch=4, seq_len=_seq(cfg, 32))).batch(0)
    tensors = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    bsh = sh.batch_shardings(tensors, mesh, use_tp)
    step = tsl.make_train_step(cfg, api, hp)
    _, got = step(state, {k: sh.place(v, bsh[k]) for k, v in tensors.items()})
    _, want = step(plain, tensors)
    return round(float(got["loss"]), 6), round(float(want["loss"]), 6)


def serve_case(arch: str, mesh, dev) -> bool:
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device=dev)
    placed = sh.place_tree(params, sh.params_shardings(params, mesh, cfg.use_tp_serve))
    seq = _seq(cfg, 16)
    batch = SyntheticTokens(cfg, DataConfig(global_batch=4, seq_len=seq)).batch(0)
    want, _ = ServeEngine(cfg, api, params, cache_cap=seq + 8).generate(batch, 4)
    got, _ = ServeEngine(cfg, api, placed, cache_cap=seq + 8).generate(batch, 4)
    return bool(np.array_equal(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = mesh_lib.make_local_mesh(1, dev)
    failures = 0
    cases = []
    for arch in args.arch:
        for use_tp in (True, False):
            for extra in ({},) + (EXTRA.get(arch, ()) if use_tp else ()):
                cases.append((f"train {arch} use_tp={use_tp} {extra}",
                              lambda a=arch, u=use_tp, e=extra: train_case(a, u, e, mesh, dev)))
        cases.append((f"serve {arch}", lambda a=arch: serve_case(a, mesh, dev)))
    for name, run in cases:
        # a probe reports every refusal of the installed DTensor, so each case
        # is caught and printed rather than ending the run
        try:
            print("OK  ", name, run(), flush=True)
        except Exception:  # genielint: ignore[broad-except]
            failures += 1
            tail = traceback.format_exc().strip().splitlines()[-4:]
            print("FAIL", name, "|", " / ".join(line.strip() for line in tail), flush=True)
    print("failures", failures, flush=True)
    torch.distributed.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
