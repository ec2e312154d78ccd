"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-360m \
        --steps 300 --global-batch 64 --seq 1024 --ckpt-dir /tmp/ck [--device cpu]

The counterpart of `repro/launch/train.py`, with its arguments and `--device`
(default: the card).  It runs on one rank: the mesh is
`mesh.make_local_mesh` over the ranks that exist (one, started here, when
no process group exists).  `--model-parallel` above 1 needs the parameter
shardings of `launch/sharding.py`, ROADMAP queue 1 item 11c-ii, and raises.
`main` returns the history.
"""
from __future__ import annotations

import argparse

from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.registry import get_api, get_config, list_archs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainHParams


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--remat", default="nothing", choices=["nothing", "dots", "none"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: sharding the parameters over a mesh's "
            "model axis is ROADMAP queue 1 item 11c-ii; this launcher trains on one rank")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    api = get_api(cfg)
    mesh = mesh_lib.make_local_mesh(args.model_parallel, device)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"mesh: {shape} over {mesh.size()} devices")

    hp = TrainHParams(
        optimizer=AdamWConfig(lr=args.lr), accum=args.accum,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
        grad_compression=args.grad_compression, remat=args.remat,
    )
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, log_every=10)
    data = DataConfig(global_batch=args.global_batch, seq_len=args.seq)

    trainer = Trainer(cfg, api, hp, tc, data, device=device)
    history = trainer.run()
    for rec in history:
        print(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
              f"lr {rec['lr']:.2e}  {rec['seconds']*1e3:.0f} ms")
    return history


if __name__ == "__main__":
    main()
