"""Decode tokens/s of chip_smoke.py's phase-6d models with `layers.silu`
(the reference's op sequence x * (1 / (1 + exp(-x))), four elementwise
launches) against `torch.nn.functional.silu` (one launch) in the SwiGLU MLP
and the MoE experts, in turns on one card.

smollm-360m at full size and qwen2-moe-a2.7b cut to 4 layers, 8
SyntheticTokens prompts of 128 tokens, `cache_cap` 256, greedy, as 6d runs
them; each variant `--reps` times in the order A B B A ...  Prints every
turn and the median of each variant, the card's name and power limit, and
one JSON line last.

  PYTHONPATH=src python tools/lm_silu_ab.py [--reps 4] [--new-tokens 32]
A check on the CPU at the smoke configs:
  PYTHONPATH=src python tools/lm_silu_ab.py --device cpu --smoke --reps 1 --new-tokens 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import get_api, get_config  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

CASES = (("smollm-360m", None), ("qwen2-moe-a2.7b", 4))
VARIANTS = {"layers.silu": layers.silu, "F.silu": F.silu}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs (a CPU check)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    hw = card() if device.type == "cuda" else "cpu"
    order = [v for i in range(args.reps) for v in
             (("layers.silu", "F.silu") if i % 2 == 0 else ("F.silu", "layers.silu"))]
    report = {}
    for arch, depth in CASES:
        cfg = get_config(arch + ("-smoke" if args.smoke else ""))
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        api = get_api(cfg)
        params = api.init_params(cfg, 0, device=device)
        batch = SyntheticTokens(cfg, DataConfig(seed=0, global_batch=8, seq_len=128)).batch(0)
        eng = ServeEngine(cfg, api, params, cache_cap=256)
        eng.generate(batch, max_new_tokens=4)                   # warm up
        runs = {v: [] for v in VARIANTS}
        tokens = {}
        try:
            for v in order:
                layers.silu = VARIANTS[v]
                toks, stats = eng.generate(batch, max_new_tokens=args.new_tokens)
                tokens.setdefault(v, toks)
                runs[v].append(stats.decode_tokens_per_s)
                print(f"{arch} ({cfg.n_layers} layers) {v}: {stats.decode_tokens_per_s:.2f} "
                      f"tokens/s, prefill {stats.prefill_seconds:.4f} s ({hw})", flush=True)
        finally:
            layers.silu = VARIANTS["layers.silu"]
        med = {v: statistics.median(r) for v, r in runs.items()}
        same = bool((tokens["layers.silu"] == tokens["F.silu"]).all())
        print(f"{arch}: median decode tokens/s, layers.silu {med['layers.silu']:.2f}, F.silu "
              f"{med['F.silu']:.2f}, ratio {med['layers.silu'] / med['F.silu']:.4f}; the same "
              f"greedy tokens: {same} ({hw})", flush=True)
        report[arch] = dict(runs=runs, median=med, same_tokens=same)
        del params, eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(hw)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
