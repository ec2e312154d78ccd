"""Where an SSM model's decode step parts from its teacher-forced forward,
block by block, in the port and in the JAX reference on the same weights.

For an ssm or hybrid arch (mamba2-1.3b by default) at its full width, cut
to each depth of --depths: --batch prompts of --prompt SyntheticTokens
tokens (a whole number of SSD chunks), prefill, one greedy decode step (the
port's token, fed to both packages), and the forward over the prompt, that
token and pad to the next chunk boundary, at each compute dtype of
--compute.  Printed for each package: the decode-vs-forward max |diff| of
the logits through its own prefill / decode_step / train_logits, and, for
the ssm family, by block the max |diff| of the hidden state at the new
token's position on the two paths, from a Python loop over its own
`mamba_block` / `mamba_block_decode` (the hybrid: the logits only).  The
cache holds two prompts.  The reference's functions are compiled with
`xla_allow_excess_precision` off, so that every bfloat16 intermediate
rounds as PyTorch's do (tests/test_torch_models.py says why).  The weights are the reference's initialisation, carried across
with `params_from_numpy`.

On the CPU, both packages (the reference needs JAX):
  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_decode_gap.py --depths 4 8 16
The port alone on a card, at full depth (no JAX imported; the weights are
the port's own `init_params` from --seed):
  PYTHONPATH=src python tools/lm_decode_gap.py --device cuda --port-only --batch 8
  PYTHONPATH=src python tools/lm_decode_gap.py --device cuda --port-only --batch 8 \
      --arch zamba2-2.7b --compute bfloat16 float32
Each depth ends with one JSON line.

--forward-blocks compares the two packages' teacher-forced forwards block by
block instead (ssm family, both packages, on the CPU): the reference's
hidden state enters block i of both packages, and the port's output is
held to the reference's ("alone": one block's own difference, its max and
the share of values that differ), beside the difference of the two
packages' chained hidden states ("chained"); "alone / step" is the max in
units of the bfloat16 step at the block's largest |h|:
  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_decode_gap.py --forward-blocks \
      --depths 4 8 16 --compute bfloat16 float32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_api, get_config  # noqa: E402


def _tokens(cfg, batch: int, prompt: int, seed: int) -> np.ndarray:
    return SyntheticTokens(cfg, DataConfig(seed=seed, global_batch=batch,
                                           seq_len=prompt)).batch(0)["tokens"]


def _forward_tokens(cfg, prompt: np.ndarray, nt: np.ndarray) -> np.ndarray:
    pos = prompt.shape[1]
    pad = np.zeros((prompt.shape[0], -(pos + 1) % cfg.ssd_chunk), prompt.dtype)
    return np.concatenate([prompt, nt.astype(prompt.dtype), pad], 1)


def port_gap(cfg, params, prompt: torch.Tensor, full: torch.Tensor) -> dict:
    """The port: the API's gap at the logits, the new token, and by block
    (max |diff|, max |h| of the forward) from a loop over its blocks."""
    api = get_api(cfg)
    pos = prompt.shape[1]
    with torch.no_grad():
        last, cache, _ = api.prefill(cfg, params, {"tokens": prompt}, cache_cap=2 * pos)
        nt = torch.argmax(last, -1)[:, None].to(torch.int32)
        step, _ = api.decode_step(cfg, params, nt, cache, pos)
        full = torch.cat([prompt, nt.to(prompt.dtype), full[:, pos + 1:]], 1)
        logits, _, _ = api.train_logits(cfg, params, {"tokens": full})
        api_gap = float((step - logits[:, pos]).abs().max())
        if cfg.family != "ssm":
            return dict(api=api_gap, loop=None, blocks=[], token=nt.cpu().numpy())

        h, states = T._embed(cfg, params, prompt), []
        for lp in params["blocks"]:
            h, st = S.mamba_block(h, lp, cfg)
            states.append(st)
        hd, hf = T._embed(cfg, params, nt), T._embed(cfg, params, full)
        blocks = []
        for lp, (tail, st) in zip(params["blocks"], states, strict=True):
            hd, _, _ = S.mamba_block_decode(hd, lp, cfg, tail, st)
            hf, _ = S.mamba_block(hf, lp, cfg)
            d, f = hd[:, 0].float(), hf[:, pos].float()
            blocks.append((float((d - f).abs().max()), float(f.abs().max())))
        loop_gap = float((T._head(cfg, params, hd)[:, 0]
                          - T._head(cfg, params, hf)[:, pos]).abs().max())
    return dict(api=api_gap, loop=loop_gap, blocks=blocks, token=nt.cpu().numpy())


def reference_gap(arch: str, depth: int, compute: str, tree: dict, prompt: np.ndarray,
                  nt: np.ndarray, full: np.ndarray) -> dict:
    """The reference on the same weights and tokens, each function compiled
    with every bfloat16 intermediate rounded."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro.models import ssm as JS
    from repro.models.registry import get_api as jget_api
    from repro.models.registry import get_config as jget_config

    jcfg = dataclasses.replace(jget_config(arch), n_layers=depth, compute_dtype=compute)
    japi = jget_api(jcfg)
    compiled = {}

    def strict(name, fn, *args):
        key = (name,) + tuple((x.shape, str(x.dtype)) for x in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                {"xla_allow_excess_precision": False})
        return compiled[key](*args)

    pos = prompt.shape[1]
    w = jax.tree_util.tree_map(jnp.asarray, tree)
    last, cache, jpos = strict("prefill", lambda w, t: japi.prefill(
        jcfg, w, {"tokens": t}, cache_cap=2 * pos), w, jnp.asarray(prompt))
    step, _ = strict("decode", lambda w, t, c, p: japi.decode_step(jcfg, w, t, c, p),
                     w, jnp.asarray(nt), cache, jpos)
    logits, _, _ = strict("forward", lambda w, t: japi.train_logits(
        jcfg, w, {"tokens": t}, remat=False), w, jnp.asarray(full))
    api_gap = float(jnp.abs(step - logits[:, pos]).max())
    ref_token = np.asarray(jnp.argmax(last, -1))

    def embed(t):
        return jnp.take(w["embed"], t, axis=0).astype(JL.cdtype(jcfg))

    def head(h):
        hn = JL.rms_norm(h, w["final_ln"], jcfg.rms_eps)
        return jnp.einsum("bsd,dv->bsv", hn, w["embed"].T.astype(hn.dtype)).astype(jnp.float32)

    layers = [jax.tree_util.tree_map(lambda x, i=i: x[i], w["blocks"]) for i in range(depth)]
    h, states = embed(jnp.asarray(prompt)), []
    for lp in layers:
        h, st = strict("block", lambda h, lp: JS.mamba_block(h, lp, jcfg), h, lp)
        states.append(st)
    hd, hf = embed(jnp.asarray(nt)), embed(jnp.asarray(full))
    blocks = []
    for lp, (tail, st) in zip(layers, states, strict=True):
        hd, _, _ = strict("block_decode",
                          lambda h, lp, c, s: JS.mamba_block_decode(h, lp, jcfg, c, s),
                          hd, lp, tail, st)
        hf, _ = strict("block", lambda h, lp: JS.mamba_block(h, lp, jcfg), hf, lp)
        d, f = hd[:, 0].astype(jnp.float32), hf[:, pos].astype(jnp.float32)
        blocks.append((float(jnp.abs(d - f).max()), float(jnp.abs(f).max())))
    loop_gap = float(jnp.abs(strict("head", head, hd)[:, 0]
                             - strict("head", head, hf)[:, pos]).max())
    return dict(api=api_gap, loop=loop_gap, blocks=blocks, token=ref_token)


def bf16_step(x: float) -> float:
    """The spacing of bfloat16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(x, 2.0 ** -126))) - 7)


def forward_blocks(arch: str, depth: int, compute: str, tree: dict,
                   tokens: np.ndarray) -> dict:
    """By block: the port's `mamba_block` on the reference's input against the
    reference's `mamba_block` (alone), and the two packages' chained hidden
    states (chained), each as (max |diff|, max |h|)."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro.models import ssm as JS
    from repro.models.registry import get_config as jget_config

    jcfg = dataclasses.replace(jget_config(arch), n_layers=depth, compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch), n_layers=depth, compute_dtype=compute)
    params = get_api(cfg).params_from_numpy(cfg, tree, device="cpu")
    w = jax.tree_util.tree_map(jnp.asarray, tree)
    block = jax.jit(lambda h, lp: JS.mamba_block(h, lp, jcfg)[0]).lower(
        jnp.take(w["embed"], jnp.asarray(tokens), axis=0).astype(JL.cdtype(jcfg)),
        jax.tree_util.tree_map(lambda x: x[0], w["blocks"])).compile(
            {"xla_allow_excess_precision": False})
    h_ref = jnp.take(w["embed"], jnp.asarray(tokens), axis=0).astype(JL.cdtype(jcfg))
    h_port = T._embed(cfg, params, torch.from_numpy(tokens))
    rows = []
    with torch.no_grad():
        for i, lp in enumerate(params["blocks"]):
            want = block(h_ref, jax.tree_util.tree_map(lambda x, i=i: x[i], w["blocks"]))
            want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
            h_in = torch.from_numpy(np.array(h_ref.astype(jnp.float32))).to(h_port.dtype)
            alone, _ = S.mamba_block(h_in, lp, cfg)
            h_port, _ = S.mamba_block(h_port, lp, cfg)
            top = float(want_t.abs().max())
            rows.append(dict(alone=float((alone.float() - want_t).abs().max()),
                             alone_share=float((alone.float() != want_t).float().mean()),
                             chained=float((h_port.float() - want_t).abs().max()),
                             max_h=top, step=bf16_step(top)))
            h_ref = want
    return dict(blocks=rows)


def run_forward_blocks(arch: str, depth: int | None, computes: list, batch: int,
                       prompt_len: int, seed: int) -> list:
    cfg = get_config(arch)
    depth = depth or cfg.n_layers
    if cfg.family != "ssm":
        raise SystemExit("--forward-blocks covers the ssm family")
    tree = reference_tree(arch, depth, seed)
    tokens = _tokens(cfg, batch, prompt_len, seed)
    outs = []
    for compute in computes:
        t0 = time.perf_counter()
        rows = forward_blocks(arch, depth, compute, tree, tokens)["blocks"]
        print(f"{arch}, {depth} blocks, batch {batch}, prompt {prompt_len}, {compute} "
              "compute, cpu: the forward by block, port against reference")
        print("  block  alone max|diff|  share differing  chained max|diff|  max|h|  "
              "bfloat16 step  alone / step")
        for i, r in enumerate(rows):
            print(f"  {i:5d}  {r['alone']:15.6g}  {r['alone_share']:15.6f}  "
                  f"{r['chained']:17.6g}  {r['max_h']:6.4g}  {r['step']:13.6g}  "
                  f"{r['alone'] / r['step']:12.3f}")
        out = dict(arch=arch, depth=depth, compute=compute, batch=batch, prompt=prompt_len,
                   mode="forward-blocks", alone=[r["alone"] for r in rows],
                   alone_share=[r["alone_share"] for r in rows],
                   chained=[r["chained"] for r in rows], max_h=[r["max_h"] for r in rows],
                   alone_in_steps=max(r["alone"] / r["step"] for r in rows),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


def reference_tree(arch: str, depth: int, seed: int) -> dict:
    import jax

    from repro.models.registry import get_api as jget_api
    from repro.models.registry import get_config as jget_config

    jcfg = dataclasses.replace(jget_config(arch), n_layers=depth)
    init = jax.jit(jget_api(jcfg).init_params, static_argnums=0)
    return jax.tree_util.tree_map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))


def run_depth(arch: str, depth: int | None, computes: list, batch: int, prompt_len: int,
              seed: int, device: torch.device, reference: bool) -> list:
    cfg = get_config(arch)
    depth = depth or cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=depth)
    if cfg.family not in ("ssm", "hybrid") or prompt_len % cfg.ssd_chunk:
        raise SystemExit(f"{arch}: an ssm or hybrid arch and a prompt of whole SSD chunks "
                         f"({cfg.ssd_chunk}) are needed")
    if reference and cfg.family != "ssm":
        raise SystemExit("the reference side covers the ssm family: pass --port-only")
    tree = reference_tree(arch, depth, seed) if reference else None
    api = get_api(cfg)
    params = (api.params_from_numpy(cfg, tree, device=device) if reference
              else api.init_params(cfg, seed, device=device))
    prompt = _tokens(cfg, batch, prompt_len, seed)
    outs = []
    for compute in computes:
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, compute_dtype=compute)
        full = _forward_tokens(c, prompt, np.zeros((batch, 1), prompt.dtype))
        port = port_gap(c, params, torch.from_numpy(prompt).to(device),
                        torch.from_numpy(full).to(device))
        out = dict(arch=arch, depth=depth, compute=compute, batch=batch, prompt=prompt_len,
                   device=str(device), port_api=port["api"], port_loop=port["loop"])
        ref = None
        if reference:
            full = _forward_tokens(c, prompt, port["token"])
            ref = reference_gap(arch, depth, compute, tree, prompt, port["token"], full)
            out.update(reference_api=ref["api"], reference_loop=ref["loop"],
                       same_token=bool(np.array_equal(ref["token"], port["token"][:, 0])))
        print(f"{arch} ({c.family}), {depth} blocks, batch {batch}, prompt {prompt_len}, "
              f"{compute} compute, {device}: decode - forward at the logits, port "
              f"{port['api']:.6f}" + ("" if ref is None else
                                      f", reference {ref['api']:.6f}"))
        if port["blocks"]:
            print("  block  port max|diff|  max|h|" + ("" if ref is None else
                                                       "   reference max|diff|  max|h|"))
        for i, (d, f) in enumerate(port["blocks"]):
            line = f"  {i:5d}  {d:14.6g}  {f:7.4g}"
            if ref is not None:
                rd, rf = ref["blocks"][i]
                line += f"   {rd:20.6g}  {rf:7.4g}"
            print(line)
        out["port_blocks"] = [d for d, _ in port["blocks"]]
        if ref is not None:
            out["reference_blocks"] = [d for d, _ in ref["blocks"]]
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--depths", type=int, nargs="*", default=[None],
                    help="blocks to keep (default: the config's)")
    ap.add_argument("--compute", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--port-only", action="store_true", help="skip the reference (no JAX)")
    ap.add_argument("--forward-blocks", action="store_true",
                    help="the two packages' forwards by block (CPU, ssm family)")
    args = ap.parse_args(argv)
    if args.forward_blocks:
        for depth in args.depths:
            run_forward_blocks(args.arch, depth, args.compute, args.batch, args.prompt,
                               args.seed)
        return 0
    device = torch.device(args.device)
    reference = not args.port_only
    if reference and device.type != "cpu":
        raise SystemExit("the reference runs on the CPU only: pass --port-only on a card")
    for depth in args.depths:
        run_depth(args.arch, depth, args.compute, args.batch, args.prompt, args.seed, device,
                  reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
