"""Training example: train a model from the zoo on the synthetic pipeline with
checkpoint/restart.  Defaults to a quick demo config; pass --arch
smollm-360m --steps 300 for the ~100M-class run on the card.

    python -m repro_torch.examples.train_lm [--arch smollm-360m-smoke] \
        [--steps 60] [--device cpu]

The counterpart of `examples/train_lm.py`, with its arguments and defaults
and `--device` (default: the card).  `main` returns the history.
"""
import argparse

from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import get_api, get_config, list_archs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainHParams


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke", choices=list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    api = get_api(cfg)
    hp = TrainHParams(
        optimizer=AdamWConfig(lr=args.lr), total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        grad_compression=args.grad_compression,
    )
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=max(args.steps // 4, 1), log_every=10)
    trainer = Trainer(cfg, api, hp, tc, DataConfig(global_batch=args.batch, seq_len=args.seq),
                      device=args.device)
    history = trainer.run()
    for rec in history:
        print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
              f"grad_norm {rec['grad_norm']:.3f}  {rec['seconds']*1e3:.0f} ms")
    print(f"final loss: {history[-1]['loss']:.4f} (from {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
