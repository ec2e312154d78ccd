"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-360m \
        --steps 300 --global-batch 64 --seq 1024 --ckpt-dir /tmp/ck [--device cpu]

The counterpart of `repro/launch/train.py`, with its arguments and `--device`
(default: the card).  As the reference does, it always trains through the
shardings, on one rank too: the mesh is `mesh.make_local_mesh(
--model-parallel)` over the ranks that exist (one, started here, when no
process group exists; several when a launcher started them, each calling
`torch.distributed.init_process_group` first), the parameters are placed by
`sharding.params_shardings(..., cfg.use_tp)` and the state by
`state_shardings`, and the Trainer runs inside `use_mesh`.  A
`--model-parallel` that does not divide the ranks raises.  `main` returns
the history.
"""
from __future__ import annotations

import argparse

from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.launch import sharding as sh_lib
from repro_torch.models.registry import get_api, get_config, list_archs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainHParams
from repro_torch.train import step as tsl


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

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    api = get_api(cfg)
    mesh = mesh_lib.make_local_mesh(args.model_parallel, device)
    print(f"mesh: {mesh_lib.axis_sizes(mesh)} over {mesh.size()} devices")

    hp = TrainHParams(
        optimizer=AdamWConfig(lr=args.lr), accum=args.accum,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
        grad_compression=args.grad_compression, remat=args.remat,
    )
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, log_every=10)
    data = DataConfig(global_batch=args.global_batch, seq_len=args.seq)

    with mesh_lib.use_mesh(mesh):
        pshapes = shapes_lib.param_specs(cfg, api)
        psh = sh_lib.params_shardings(pshapes, mesh, cfg.use_tp)
        ssh = sh_lib.state_shardings(
            tsl.TrainState(params=pshapes, opt=None,
                           compress_error=pshapes if hp.grad_compression else None),
            psh, mesh)
        trainer = Trainer(cfg, api, hp, tc, data, shardings=ssh, device=device)
        history = trainer.run()
    for rec in history:
        print(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
              f"lr {rec['lr']:.2e}  {rec['seconds']*1e3:.0f} ms")
    return history


if __name__ == "__main__":
    main()
