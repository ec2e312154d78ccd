"""The DISTRIBUTED layout of the port against the JAX package, on 8 gloo ranks.

The port runs SPMD (one process per rank); the reference's own tests run 8
forced CPU devices under one controller.  One module-scoped fixture starts
ONE subprocess, which spawns an 8-rank gloo world on the CPU and builds both
of the reference tests' meshes in it, `(2, 4)` ("data", "model") and
`(2, 2, 2)` ("pod", "data", "model").  Every rank runs every case -- the
port's counterparts of tests/test_distributed.py, the distributed tests of
test_plan.py, test_routing.py, test_engines.py and test_engine_matrix.py --
and writes what it got to an .npz; then the subprocess runs the front-end's
placement-cache case (test_frontend.py) on a one-rank mesh.  Meanwhile this
process runs the same numpy inputs through the JAX package on the CPU: its
sort oracle, its unmeshed services, and its DISTRIBUTED plans on a
one-device mesh.  Each case is one test: `ids`, `counts` and `threshold`
equal bit for bit, on every rank.

The same world then runs the sharded LM cases (`launch/sharding.py`, the
models' hints, the sharded train step, checkpoints and serving) on two
("data", "model") meshes, (2, 4) and (4, 2): the inputs come from this
process (the reference's weights, batch and a checkpoint it wrote, in
`lm_inputs.npz`, which the ranks wait for), and an 8-device reference
subprocess gives each device's shard of every parameter
(`devices_indices_map`).  See `LM_CASES`.

A rank that raises ends the world at once; a rank that hangs fails the
fixture at its timeout (gloo's collectives time out first)."""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from repro_torch.core import engines as _port_engines

N_RANKS = 8
MESHES = {"flat": ((2, 4), ("data", "model")), "pod": ((2, 2, 2), ("pod", "data", "model"))}
# the rank order of the "permuted" meshes: shard order != global rank order
PERMUTATION = [5, 2, 7, 0, 3, 6, 1, 4]
ENGINES = sorted(e.value for e in _port_engines.available())
METHODS = ("cpq", "spq", "sort")
K = 7
CUTS = [0, 3, 4, 40, 90, 101]
SCHEMES = ("e2lsh", "simhash", "minhash")
SERVICE_SPANS = [(0, 30), (30, 37), (37, 90), (90, 130)]
TIMEOUT_S = 240
LM_MESHES = {"m24": (2, 4), "m42": (4, 2)}
LM_ARCH = "phi3-mini-3.8b-smoke"
LM_FAMILIES = ["qwen2-moe-a2.7b-smoke", "internvl2-76b-smoke", "mamba2-1.3b-smoke",
               "zamba2-2.7b-smoke", "seamless-m4t-large-v2-smoke"]
# one AdamW step: arch -> (use_tp, mesh); the forward losses: arch -> mesh
# (each sharded step or forward on 8 gloo ranks costs seconds: one mesh a case)
LM_STEP_ARCHS = {LM_ARCH: (True, "m24"), "smollm-360m-smoke": (False, "m42")}
LM_FAMILY_MESH = dict(zip(LM_FAMILIES, ["m24", "m42", "m24", "m42", "m24"]))
LM_BATCH, LM_SEQ, LM_LR = 8, 16, 1e-3
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")


def _case_names() -> list:
    names = [f"search_step/{m}" for m in MESHES]
    names += [f"planner/{e}/{mesh}/{meth}/{merge}" for e in ENGINES for mesh in MESHES
              for meth in METHODS for merge in ("flat", "hier")]
    names += [f"packed/{e}/{mesh}/{path}" for e in ("cosine", "tanimoto") for mesh in MESHES
              for path in ("kernel", "plain")]
    names += [f"routing/{e}/{meth}/routed_verified" for e in ENGINES for meth in METHODS]
    names += ["routing/eq/cpq/routed"]
    names += [f"registry/{e}" for e in ("eq", "minsum", "ip", "range")]
    names += [f"matrix/{e}/{path}" for e in ENGINES for path in ("kernel", "plain")]
    names += [f"permuted/{m}" for m in MESHES]
    names += [f"service/{s}" for s in SCHEMES]
    names += ["service_routing/full", "service_routing/verified", "service_routing/grown",
              "frontend_placement"]
    return names


CASES = _case_names()
LM_CASES = ([f"loss/{m}" for m in LM_MESHES] + [f"shards/{m}" for m in LM_MESHES]
            + [f"step/{a}/{m}" for a, (_, m) in LM_STEP_ARCHS.items()]
            + [f"forward/{a}/{m}" for a, m in LM_FAMILY_MESH.items()]
            + [f"restore/{src}/{m}" for src in ("port", "reference") for m in LM_MESHES]
            + ["trainer_resume/m24"] + [f"decode/{m}" for m in LM_MESHES])


# ---------------------------------------------------------------------------
# Inputs: numpy, from seeds, the same on both sides
# ---------------------------------------------------------------------------

def _dyadic_e2lsh(m: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 129, size=(m, d)).astype(np.float32) / 64.0
    b = rng.integers(0, 256, size=(m,)).astype(np.float32) / 64.0
    seeds = rng.integers(0, 2**31 - 1, size=m).astype(np.uint32)
    return a, b, seeds


def _scheme_params(scheme: str, m: int, d: int, seed: int = 3):
    """Dyadic projections and integer seeds: every float product is exact in
    any order, so both packages hash identically."""
    if scheme == "e2lsh":
        return _dyadic_e2lsh(m, d, seed)
    rng = np.random.default_rng(seed)
    if scheme == "simhash":
        return (rng.integers(-128, 129, size=(m, d)).astype(np.float32) / 64.0,)
    return (rng.integers(0, 2**32, size=m, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, size=m, dtype=np.uint64).astype(np.uint32))


def _service_points():
    rng = np.random.default_rng(0)
    pts = rng.integers(-6, 7, size=(130, 16)).astype(np.float32)
    return pts, pts[88:96] + 0.25


def _routing_points():
    """Six clusters of 40 on a 1/16 grid (sign tests exact), queries near
    three of the centres."""
    rng = np.random.default_rng(0)
    centers = np.round(rng.standard_normal((6, 16)) * 16) / 16
    clusters = [np.round((centers[c] + 0.1 * rng.standard_normal((40, 16))) * 16) / 16
                for c in range(6)]
    q = np.round((np.repeat(centers[:3], 2, axis=0) + 0.05 * rng.standard_normal((6, 16)))
                 * 16) / 16
    return ([c.astype(np.float32) for c in clusters], q.astype(np.float32),
            centers[:1].astype(np.float32))


def _registry_cases():
    """tests/test_engines.py::test_distributed_parity_all_engines's draws."""
    rng = np.random.default_rng(0)
    cases = {
        "eq": (rng.integers(0, 6, (128, 16)).astype(np.int32),
               rng.integers(0, 6, (4, 16)).astype(np.int32), 16),
        "minsum": (rng.integers(0, 3, (128, 32)).astype(np.int32),
                   rng.integers(0, 3, (4, 32)).astype(np.int32), 96),
        "ip": (rng.integers(0, 2, (128, 32)).astype(np.int32),
               rng.integers(0, 2, (4, 32)).astype(np.int32), 32),
    }
    lo = rng.integers(0, 5, (4, 6)).astype(np.int32)
    cases["range"] = (rng.integers(0, 10, (128, 6)).astype(np.int32), (lo, lo + 3), 6)
    return cases


def _search_step_inputs():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 6, (128, 16)).astype(np.int32),
            rng.integers(0, 6, (4, 16)).astype(np.int32))


# ---------------------------------------------------------------------------
# The port's side: run by every rank of the 8-rank world
# ---------------------------------------------------------------------------

def _put(out: dict, name: str, res) -> None:
    for field in ("ids", "counts", "threshold"):
        value = getattr(res, field)
        out[f"{name}|{field}"] = value.numpy() if hasattr(value, "numpy") else np.asarray(value)


def _port_service(scheme: str, m: int, d: int, mesh, **kw):
    from repro_torch.core.lsh import e2lsh, minhash, simhash
    from repro_torch.serve import RetrievalService

    p = _scheme_params(scheme, m, d)
    params = {"e2lsh": lambda: e2lsh.params_from_numpy(*p, 4.0, 2, 8192, device="cpu"),
              "simhash": lambda: simhash.params_from_numpy(*p, device="cpu"),
              "minhash": lambda: minhash.params_from_numpy(*p, 8192, device="cpu")}[scheme]()
    return RetrievalService(embed_fn=np.asarray, scheme=scheme, m_override=m, mesh=mesh,
                            device="cpu", params=params, **kw)


def _rank_cases(meshes: dict, permuted: dict) -> dict:
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core import SegmentedIndex, distributed, engines, match
    from repro_torch.core import cpq as cpq_lib
    from repro_torch.core import merge as merge_lib
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.types import SearchParams, SignatureLayout, TopKMethod
    from repro_torch.kernels import cpq_compact as compact_lib

    cpu = torch.device("cpu")
    out: dict = {}

    def shard(mesh, data):
        return distribute_tensor(data, mesh, distributed.data_sharding(mesh), src_data_rank=None)

    def replicate(mesh, queries):
        if isinstance(queries, tuple):
            return tuple(replicate(mesh, q) for q in queries)
        return distribute_tensor(queries, mesh, distributed.replicated(mesh, 2),
                                 src_data_rank=None)

    # tests/test_distributed.py::test_distributed_search_matches_oracle
    data, queries = (torch.from_numpy(x) for x in _search_step_inputs())
    for name, mesh in meshes.items():
        maker = (distributed.make_search_step if name == "flat"
                 else distributed.make_hierarchical_search_step)
        step = maker(mesh, SearchParams(k=K, max_count=16), match.match_eq)
        _put(out, f"search_step/{name}", step(shard(mesh, data), replicate(mesh, queries)))

    # test_plan.py::test_planner_distributed_parity and
    # test_engine_matrix.py::test_matrix_distributed_parity
    for eng in ENGINES:
        model = engines.get(eng)
        raw, rawq, mc = model.example(np.random.default_rng(0), 128, 4)
        data, queries = model.prepare_data(raw, cpu), model.prepare_queries(rawq, cpu)
        mx = model.resolve_max_count(data, mc)
        for name, mesh in meshes.items():
            dd, qq = shard(mesh, data), replicate(mesh, queries)
            for method in METHODS:
                for merge in ("flat", "hier"):
                    plan = plan_lib.plan_search(
                        eng, K, mx, layout=plan_lib.Layout.DISTRIBUTED,
                        method=TopKMethod(method), use_kernel=False,
                        hierarchical=merge == "hier", mesh_axes=mesh.mesh_dim_names)
                    _put(out, f"planner/{eng}/{name}/{method}/{merge}",
                         plan_lib.execute(plan, dd, qq, mesh=mesh))
        mesh = meshes["flat"]
        for path in ("kernel", "plain"):
            params = SearchParams(k=K, max_count=mx, use_kernel=path == "kernel")
            step = distributed.make_search_step(mesh, params, eng)
            # the whole tensors: every rank takes its own row block
            _put(out, f"matrix/{eng}/{path}", step(data, queries))

    # test_plan.py::test_planner_distributed_packed_parity (and on the pod mesh)
    for eng in ("cosine", "tanimoto"):
        model = engines.get(eng)
        raw, rawq, mc = model.example(np.random.default_rng(0), 130, 4)
        mx = model.resolve_max_count(model.prepare_data(raw, cpu), mc)
        seg = SegmentedIndex(engine=eng, max_count=mx, device=cpu,
                             signature_layout=SignatureLayout.PACKED)
        seg.add(raw[:40])
        seg.add(raw[40:130])
        pdata, n = seg.concat_data(pad_multiple=N_RANKS)
        assert pdata.shape[0] == 136 and n == 130
        qq = model.prepare_queries_for(rawq, cpu, SignatureLayout.PACKED)
        for name, mesh in meshes.items():
            maker = (distributed.make_search_step if name == "flat"
                     else distributed.make_hierarchical_search_step)
            for path in ("kernel", "plain"):
                params = SearchParams(k=K, max_count=mx, use_kernel=path == "kernel")
                step = maker(mesh, params, eng, n_objects=n,
                             signature_layout=SignatureLayout.PACKED)
                _put(out, f"packed/{eng}/{name}/{path}", step(shard(mesh, pdata), qq))

    # test_routing.py::test_distributed_routing_parity
    mesh = meshes["flat"]
    for eng in ENGINES:
        model = engines.get(eng)
        raw, rawq, mc = model.example(np.random.default_rng(0), 101, 4)
        seg = SegmentedIndex(engine=eng, max_count=mc, use_kernel=False, device=cpu)
        for a, b in zip(CUTS, CUTS[1:]):
            seg.add(raw[a:b])
        data, n = seg.concat_data(pad_multiple=mesh.size())
        queries = model.prepare_queries(rawq, cpu)
        dd, qq, router = shard(mesh, data), replicate(mesh, queries), seg.router()
        for method in METHODS:
            modes = [("routed_verified", 1)]
            if method == "cpq" and eng == "eq":
                modes.append(("routed", len(CUTS) - 1))
            for mode, npb in modes:
                plan = plan_lib.plan_search(
                    eng, K, seg.max_count, layout=plan_lib.Layout.DISTRIBUTED, n_objects=n,
                    method=TopKMethod(method), use_kernel=False,
                    mesh_axes=mesh.mesh_dim_names, routing=mode, nprobe=npb)
                _put(out, f"routing/{eng}/{method}/{mode}",
                     plan_lib.execute(plan, dd, qq, mesh=mesh, router=router,
                                      route_queries=queries))

    # test_engines.py::test_distributed_parity_all_engines
    for eng, (data, queries, mx) in _registry_cases().items():
        queries = (tuple(torch.from_numpy(q) for q in queries) if isinstance(queries, tuple)
                   else torch.from_numpy(queries))
        step = distributed.make_search_step(mesh, SearchParams(k=K, max_count=mx), eng)
        _put(out, f"registry/{eng}", step(shard(mesh, torch.from_numpy(data)),
                                          replicate(mesh, queries)))

    # the shard order: meshes whose ranks are not in global-rank order
    data, queries = (torch.from_numpy(x) for x in _search_step_inputs())
    for name, mesh in permuted.items():
        maker = (distributed.make_search_step if name == "flat"
                 else distributed.make_hierarchical_search_step)
        step = maker(mesh, SearchParams(k=K, max_count=16), "eq")
        _put(out, f"permuted/{name}", step(shard(mesh, data), queries))
        # the same buffers merged in global-rank order, as a gather over the
        # world lists them: what the port would return without its reorder
        plan = plan_lib.plan_search("eq", K, 16, layout=plan_lib.Layout.DISTRIBUTED)
        s = plan_lib._shard_linear_index(mesh)
        gids, gcnt = plan_lib._part_topk(plan, shard(mesh, data).to_local(), queries, s * 16)
        pair = torch.stack([gids, gcnt])
        bufs = [torch.empty_like(pair) for _ in range(N_RANKS)]
        torch.distributed.all_gather(bufs, pair)
        stacked = torch.stack(bufs)
        _put(out, f"permuted_naive/{name}",
             merge_lib.merge_topk(stacked[:, 0], stacked[:, 1], K))

    # test_plan.py::test_retrieval_service_sharded_serving_parity
    pts, q = _service_points()
    mesh = meshes["flat"]
    for scheme in SCHEMES:
        svc = _port_service(scheme, 96, 16, mesh)
        for a, b in SERVICE_SPANS:
            svc.add(list(range(a, b)), embeddings=pts[a:b])
        res, sims = svc.search(None, k=5, embeddings=q)
        _put(out, f"service/{scheme}", res)
        out[f"service/{scheme}|sims"] = sims
        placed = svc._placed
        svc.search(None, k=5, embeddings=q)
        hit = svc._placed is placed
        svc.add([999], embeddings=pts[:1])
        svc.search(None, k=5, embeddings=q)
        out[f"service/{scheme}|cache"] = np.asarray(
            [hit, svc._placed is not placed, svc.items_for(res.ids)[0][0] is not None])

    # test_routing.py::test_distributed_service_routing_parity
    clusters, q, extra = _routing_points()
    svc = _port_service("simhash", 64, 16, mesh)
    base = 0
    for pts in clusters:
        svc.add(list(range(base, base + len(pts))), embeddings=pts)
        base += len(pts)
    full, _ = svc.search(None, k=5, embeddings=q)
    seen = []
    orig = cpq_lib._compact_candidates

    def spy(counts, threshold, cap):
        seen.append(int(cap))
        return orig(counts, threshold, cap)

    # the plain compaction under both of its names: c-PQ's own (the plain
    # path) and the kernel wrapper's, which takes it for CPU tensors
    cpq_lib._compact_candidates = compact_lib.cpq_compact_plain = spy
    try:
        ver, _ = svc.search(None, k=5, embeddings=q, routing="routed_verified",
                            candidate_cap=31)
    finally:
        cpq_lib._compact_candidates = compact_lib.cpq_compact_plain = orig
    router = svc._router()
    cached = svc._router() is router
    svc.add([999], embeddings=extra)
    refreshed = svc._router() is not router
    grown, _ = svc.search(None, k=5, embeddings=q, routing="routed_verified")
    _put(out, "service_routing/full", full)
    _put(out, "service_routing/verified", ver)
    _put(out, "service_routing/grown", grown)
    out["service_routing/verified|cache"] = np.asarray([31 in seen, cached, refreshed])
    return out


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    """One rank of the world: join it, build the meshes, run every case."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=N_RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=90))
    try:
        meshes = {name: mesh_lib.make_mesh(shape, axes, device="cpu")
                  for name, (shape, axes) in MESHES.items()}
        permuted = {name: DeviceMesh("cpu", torch.tensor(PERMUTATION).reshape(shape),
                                     mesh_dim_names=axes)
                    for name, (shape, axes) in MESHES.items()}
        out = _rank_cases(meshes, permuted)
        out.update(_lm_rank_cases(out_dir))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The sharded LM cases: the port's side, run by every rank
# ---------------------------------------------------------------------------

def _unflat(flat: dict, prefix: str) -> dict:
    """{'a/b': x} under `prefix/` -> {'a': {'b': x}}."""
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _lm_batch(tokens, cfg):
    import torch

    b = {"tokens": torch.from_numpy(tokens)}
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((tokens.shape[0], cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        b["frames"] = torch.from_numpy(
            rng.standard_normal(tokens.shape + (cfg.d_model,)).astype(np.float32))
    return b


def _lm_rank_cases(out_dir: str) -> dict:
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpointer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shapes, sharding
    from repro_torch.models import partition
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve import ServeEngine
    from repro_torch.train import Trainer, TrainerConfig, TrainHParams
    from repro_torch.train import step as tsl
    from repro_torch.tree import leaves

    ready = os.path.join(out_dir, "lm_inputs.npz")
    deadline = time.monotonic() + 150
    while not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise TimeoutError("the LM inputs never came")
        time.sleep(0.1)
    inputs = dict(np.load(ready))
    meshes = {k: mesh_lib.make_mesh(v, ("data", "model"), device="cpu")
              for k, v in LM_MESHES.items()}
    out: dict = {}

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x


    def model(arch, compute, tree=None):
        cfg = dataclasses.replace(get_config(arch), compute_dtype=compute)
        api = get_api(cfg)
        params = (api.params_from_numpy(cfg, tree, device="cpu") if tree is not None
                  else api.init_params(cfg, 0, device="cpu"))
        return cfg, api, params

    def loss_of(cfg, api, params, batch, mesh=None, use_tp=None):
        use_tp = cfg.use_tp if use_tp is None else use_tp
        cfg = dataclasses.replace(cfg, use_tp=use_tp)
        fn = tsl.make_loss_fn(cfg, api, TrainHParams(remat=False))
        if mesh is None:
            with torch.no_grad():
                return float(fn(params, batch)[0])
        placed = sharding.place_tree(params, sharding.params_shardings(params, mesh, use_tp))
        bsh = sharding.batch_shardings(batch, mesh, use_tp)
        with partition.sharded_scope(mesh), torch.no_grad():
            loss = fn(placed, {k: sharding.place(v, bsh[k]) for k, v in batch.items()})[0]
        return float(whole(loss))

    ref_tree = _unflat(inputs, f"tree/{LM_ARCH}")
    tokens = inputs["batch/tokens"]
    # the sharded loss against the reference's and the port's unsharded
    for name, mesh in meshes.items():
        for compute in ("bfloat16", "float32"):
            cfg, api, params = model(LM_ARCH, compute, ref_tree)
            batch = _lm_batch(tokens, cfg)
            out[f"lm/loss/{name}|{compute}"] = np.asarray(
                [loss_of(cfg, api, params, batch, mesh), loss_of(cfg, api, params, batch)])
    # each rank's shard of every parameter, beside its mesh coordinate
    for name, mesh in meshes.items():
        cfg, api, params = model(LM_ARCH, "bfloat16", ref_tree)
        placed = sharding.place_tree(params, sharding.params_shardings(params, mesh, True))
        out[f"lm/shards/{name}|coord"] = np.asarray(mesh.get_coordinate())
        for key, local in _leaf_items(placed):
            out[f"lm/shards/{name}|{key}"] = local.to_local().detach().numpy()
    # one AdamW step, sharded against unsharded (float32 compute)
    for arch, (use_tp, name) in LM_STEP_ARCHS.items():
        tree, mesh = _unflat(inputs, f"tree/{arch}"), meshes[name]
        got = {}
        for how in ("plain", "sharded"):
            cfg, api, params = model(arch, "float32", tree)
            cfg = dataclasses.replace(cfg, use_tp=use_tp)
            hp = TrainHParams(optimizer=AdamWConfig(lr=LM_LR), remat="nothing",
                              warmup_steps=1, total_steps=10)
            state = tsl.state_from_params(params, hp)
            batch = _lm_batch(tokens, cfg)
            if how == "sharded":
                psh = sharding.params_shardings(params, mesh, use_tp)
                state = sharding.place_tree(state, sharding.state_shardings(state, psh, mesh))
                bsh = sharding.batch_shardings(batch, mesh, use_tp)
                batch = {k: sharding.place(v, bsh[k]) for k, v in batch.items()}
            state, metrics = tsl.make_train_step(cfg, api, hp)(state, batch)
            got[how] = (float(metrics["grad_norm"]), float(metrics["loss"]),
                        [whole(p).detach() for p in leaves(state.params)])
        out[f"lm/step/{arch}/{name}|scalars"] = np.asarray(
            [got["sharded"][0], got["plain"][0], got["sharded"][1], got["plain"][1]])
        out[f"lm/step/{arch}/{name}|param_err"] = np.asarray(max(
            float((a - b).abs().max()) for a, b in zip(got["sharded"][2], got["plain"][2])))
    # every other family's forward loss, sharded against unsharded
    for arch, name in LM_FAMILY_MESH.items():
        mesh = meshes[name]
        cfg, api, params = model(arch, "float32")
        seq = LM_SEQ if cfg.family not in ("ssm", "hybrid") else 2 * cfg.ssd_chunk
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (LM_BATCH, seq)).astype(np.int32)
        batch = _lm_batch(toks, cfg)
        out[f"lm/forward/{arch}/{name}|loss"] = np.asarray(
            [loss_of(cfg, api, params, batch, mesh), loss_of(cfg, api, params, batch)])
    # elastic restore: the port's checkpoint written on (2, 4), and the
    # reference's, each restored onto both meshes
    cfg, api, params = model(LM_ARCH, "bfloat16", ref_tree)
    hp = TrainHParams()
    state = tsl.state_from_params(params, hp)
    psh24 = sharding.params_shardings(params, meshes["m24"], True)
    placed = sharding.place_tree(state, sharding.state_shardings(state, psh24, meshes["m24"]))
    port_dir = os.path.join(out_dir, "lm_port_ckpt")
    checkpointer.save(port_dir, 7, placed, extra=dict(data_step=7))
    ref_dir = os.path.join(out_dir, "lm_ref_ckpt")
    with np.load(os.path.join(ref_dir, "step_00000003", "arrays.npz")) as z:
        ref_arrays = {k: z[k] for k in z.files}
    sources = {"port": (port_dir, 7, checkpointer._flatten(state)),
               "reference": (ref_dir, 3, ref_arrays)}
    for src, (d, step, want_flat) in sources.items():
        for name, mesh in meshes.items():
            template = tsl.state_from_params(model(LM_ARCH, "bfloat16", ref_tree)[2], hp)
            ssh = sharding.state_shardings(
                template, sharding.params_shardings(template.params, mesh, True), mesh)
            restored, _ = checkpointer.restore(d, step, template, ssh)
            flat = checkpointer._flatten(restored)
            placed_ok = all(type(x).__name__ == "DTensor" and tuple(x.placements) == s.placements
                            for x, s in zip(leaves(restored.params),
                                            sharding.leaves_of(ssh.params)))
            out[f"lm/restore/{src}/{name}|ok"] = np.asarray([
                sorted(flat) == sorted(want_flat),
                all(flat[k].dtype == want_flat[k].dtype and np.array_equal(flat[k], want_flat[k])
                    for k in want_flat if k in flat),
                placed_ok])
    # a sharded Trainer: 2 steps + a checkpoint + 2 in a fresh one = 4 straight
    cfg = get_config("smollm-360m-smoke")
    api = get_api(cfg)
    mesh = meshes["m24"]
    pshapes = shapes.param_specs(cfg, api)
    ssh = sharding.state_shardings(tsl.TrainState(pshapes, None, None),
                                   sharding.params_shardings(pshapes, mesh, cfg.use_tp), mesh)
    hp = TrainHParams(optimizer=AdamWConfig(lr=LM_LR), total_steps=4, warmup_steps=1)
    data = DataConfig(global_batch=LM_BATCH, seq_len=LM_SEQ)

    def trainer(ckpt_dir, total):
        tc = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=1)
        t = Trainer(cfg, api, hp, tc, data, shardings=ssh, device="cpu")
        t.run()
        return t

    straight = trainer(None, 4)
    ck = os.path.join(out_dir, "lm_trainer_ckpt")
    trainer(ck, 2)
    resumed = trainer(ck, 4)
    a = [whole(x) for x in leaves(straight.final_state.params) + leaves(straight.final_state.opt.m)]
    b = [whole(x) for x in leaves(resumed.final_state.params) + leaves(resumed.final_state.opt.m)]
    out["lm/trainer_resume/m24|ok"] = np.asarray([
        all(torch.equal(x, y) for x, y in zip(a, b)),
        [r["loss"] for r in straight.history][2:] == [r["loss"] for r in resumed.history]])
    # prefill + decode with the caches placed by cache_shardings
    for name, mesh in meshes.items():
        cfg, api, params = model(LM_ARCH, "float32", ref_tree)
        batch = _lm_batch(tokens, cfg)
        plain_toks, _ = ServeEngine(cfg, api, params, cache_cap=LM_SEQ + 8).generate(batch, 4)
        placed = sharding.place_tree(params, sharding.params_shardings(params, mesh,
                                                                       cfg.use_tp_serve))
        toks, _ = ServeEngine(cfg, api, placed, cache_cap=LM_SEQ + 8).generate(batch, 4)
        last, cache, pos = api.prefill(cfg, params, batch, cache_cap=LM_SEQ + 8)
        nt = torch.argmax(last, -1)[:, None].to(torch.int32)
        want, _ = api.decode_step(cfg, params, nt, cache, pos)
        bsh = sharding.batch_shardings(batch, mesh, cfg.use_tp_serve)
        with partition.sharded_scope(mesh):
            last_s, cache_s, pos_s = api.prefill(
                cfg, placed, {k: sharding.place(v, bsh[k]) for k, v in batch.items()},
                cache_cap=LM_SEQ + 8)
            csh = sharding.cache_shardings(cfg, cache_s, mesh)
            cache_s = sharding.place_tree(cache_s, csh)
            got, cache_s = api.decode_step(cfg, placed, nt, cache_s, pos_s)
            placed_ok = all(tuple(cache_s[k].placements) == csh[k].placements for k in csh)
        out[f"lm/decode/{name}|tokens"] = np.stack([toks, plain_toks])
        out[f"lm/decode/{name}|err"] = np.asarray(
            [float((whole(got) - want).abs().max()), float((whole(last_s) - last).abs().max()),
             float(placed_ok)])
    dist.barrier()
    return out


def _leaf_items(tree, path=()):
    """(key, leaf) over a port tree; a list position is a key part."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaf_items(x, path + (str(i),))
    else:
        yield "/".join(path), tree



def _frontend_case() -> dict:
    """test_frontend.py::test_sharded_placement_cache_refreshes_on_churn, on
    a one-rank mesh this process starts by itself."""
    from repro_torch.core.lsh import e2lsh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import ServingFrontend

    mesh = mesh_lib.make_mesh((1,), ("data",), device="cpu")
    pts = np.random.default_rng(5).integers(-6, 7, size=(64, 6)).astype(np.float32)
    fe = ServingFrontend(mesh=mesh, max_wait_us=0)
    try:
        params = e2lsh.params_from_numpy(*_dyadic_e2lsh(8, 6, 3), 4.0, 2, 8192, device="cpu")
        svc = fe.create_tenant("t", embed_fn=np.asarray, m_override=8, params=params)
        fe.add("t", list(range(32)), embeddings=pts[:32])
        q = pts[:3] + 0.25
        res1, _ = fe.search("t", None, k=3, embeddings=q, timeout=60)
        placed1 = svc._placed
        res2, _ = fe.search("t", None, k=3, embeddings=q, timeout=60)
        hit = svc._placed is placed1 and np.array_equal(res1.ids, res2.ids)
        fe.add("t", list(range(32, 64)), embeddings=pts[32:])
        res3, _ = fe.search("t", None, k=3, embeddings=q, timeout=60)
        out = {"frontend_placement|cache": np.asarray([hit, svc._placed is not placed1])}
        _put(out, "frontend_placement", res3)
        return out
    finally:
        fe.close(timeout=60)


# imported once by the fork server, before it forks the ranks
_PRELOAD = ["torch", "torch.distributed.tensor", "repro_torch.core", "repro_torch.core.lsh",
            "repro_torch.serve", "repro_torch.launch", "test_torch_distributed"]


def _world_main(out_dir: str) -> None:
    """Run the 8-rank world (ranks forked by a fork server that imported the
    modules once; one rank that fails ends the rest at once), then the
    one-rank front-end case; results under `out_dir`."""
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, store, out_dir), daemon=True)
             for r in range(N_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S - 30
    while any(p.is_alive() for p in procs):
        failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            raise SystemExit(f"a rank failed (exit codes {[p.exitcode for p in procs]})")
        time.sleep(0.05)
    for p in procs:
        p.join(5)
    codes = [p.exitcode for p in procs]
    if codes != [0] * N_RANKS:
        raise SystemExit(f"ranks exited with {codes}")
    np.savez(os.path.join(out_dir, "main.npz"), **_frontend_case())


# ---------------------------------------------------------------------------
# The reference's side: this process, JAX on the CPU
# ---------------------------------------------------------------------------

def _reference_results() -> dict:
    import jax.numpy as jnp

    from repro.core import cpq, distributed, engines, match
    from repro.core import plan as plan_lib
    from repro.core.types import SearchParams
    from repro.launch import mesh as mesh_lib

    one = mesh_lib.make_mesh((1,), ("data",))
    pod = mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"))
    want: dict = {}

    def oracle(counts, mx):
        return cpq.sort_select(counts, SearchParams(k=K, max_count=mx))

    data, queries = (jnp.asarray(x) for x in _search_step_inputs())
    ref = oracle(match.match_eq(data, queries), 16)
    for name, mesh, maker in (("flat", one, distributed.make_search_step),
                              ("pod", pod, distributed.make_hierarchical_search_step)):
        got = maker(mesh, SearchParams(k=K, max_count=16), match.match_eq)(data, queries)
        want[f"search_step/{name}"] = [ref, got]
        want[f"permuted/{name}"] = [ref]
    for eng in ENGINES:
        model = engines.get(eng)
        raw, rawq, mc = model.example(np.random.default_rng(0), 128, 4)
        data, queries = model.prepare_data(raw), model.prepare_queries(rawq)
        mx = model.resolve_max_count(data, mc)
        ref = oracle(model.reference(data, queries), mx)
        # the reference's DISTRIBUTED plan once an engine (its own tests hold
        # every method of it to the oracle)
        plan = plan_lib.plan_search(eng, K, mx, layout=plan_lib.Layout.DISTRIBUTED,
                                    use_kernel=False, mesh_axes=("data",))
        got = plan_lib.execute(plan, data, queries, mesh=one)
        for method in METHODS:
            for mesh in MESHES:
                for merge in ("flat", "hier"):
                    want[f"planner/{eng}/{mesh}/{method}/{merge}"] = (
                        [ref, got] if method == "cpq" else [ref])
        for path in ("kernel", "plain"):
            want[f"matrix/{eng}/{path}"] = [ref]
        raw, rawq, mc = model.example(np.random.default_rng(0), 101, 4)
        data = model.prepare_data(raw)
        ref = oracle(model.reference(data, model.prepare_queries(rawq)),
                     model.resolve_max_count(data, mc))
        for method in METHODS:
            want[f"routing/{eng}/{method}/routed_verified"] = [ref]
        if eng == "eq":
            want["routing/eq/cpq/routed"] = [ref]
    for eng in ("cosine", "tanimoto"):
        model = engines.get(eng)
        raw, rawq, mc = model.example(np.random.default_rng(0), 130, 4)
        data = model.prepare_data(raw)
        ref = oracle(model.reference(data, model.prepare_queries(rawq)),
                     model.resolve_max_count(data, mc))
        for mesh in MESHES:
            for path in ("kernel", "plain"):
                want[f"packed/{eng}/{mesh}/{path}"] = [ref]
    for eng, (data, queries, mx) in _registry_cases().items():
        queries = (tuple(jnp.asarray(q) for q in queries) if isinstance(queries, tuple)
                   else jnp.asarray(queries))
        counts = engines.get(eng).match_fn(False)(jnp.asarray(data), queries)
        want[f"registry/{eng}"] = [oracle(counts, mx)]
    want.update(_reference_services())
    return want


def _jax_service(scheme: str, m: int, d: int):
    import jax.numpy as jnp

    from repro.core import SegmentedIndex
    from repro.core.lsh import e2lsh, minhash, simhash
    from repro.serve.retrieval import RetrievalService

    p = [jnp.asarray(x) for x in _scheme_params(scheme, m, d)]
    params = {"e2lsh": lambda: e2lsh.E2LSHParams(a=p[0], b=p[1], seeds=p[2], w=4.0, p=2,
                                                 n_buckets=8192),
              "simhash": lambda: simhash.SimHashParams(v=p[0]),
              "minhash": lambda: minhash.MinHashParams(seeds=p[0], rehash_seeds=p[1],
                                                       n_buckets=8192)}[scheme]()
    svc = RetrievalService(embed_fn=np.asarray, scheme=scheme, m_override=m)
    # test code only: install the parameters before the first add(), and
    # search the plain path (the reference's tests hold its interpret-mode
    # kernels to it; they would only cost time here)
    svc._params, svc._dim = params, d
    svc._index = SegmentedIndex(engine=svc._scheme.engine, max_count=m, use_kernel=False)
    return svc


def _reference_services() -> dict:
    want: dict = {}
    pts, q = _service_points()
    for scheme in SCHEMES:
        svc = _jax_service(scheme, 96, 16)
        for a, b in SERVICE_SPANS:
            svc.add(list(range(a, b)), embeddings=pts[a:b])
        res, sims = svc.search(None, k=5, embeddings=q)
        want[f"service/{scheme}"] = [res]
        want[f"service/{scheme}|sims"] = sims
    clusters, q, extra = _routing_points()
    svc = _jax_service("simhash", 64, 16)
    base = 0
    for pts in clusters:
        svc.add(list(range(base, base + len(pts))), embeddings=pts)
        base += len(pts)
    full, _ = svc.search(None, k=5, embeddings=q)
    ver, _ = svc.search(None, k=5, embeddings=q, routing="routed_verified")
    want["service_routing/full"] = [full]
    want["service_routing/verified"] = [full, ver]
    svc.add([999], embeddings=extra)
    want["service_routing/grown"] = [svc.search(None, k=5, embeddings=q)[0]]
    pts = np.random.default_rng(5).integers(-6, 7, size=(64, 6)).astype(np.float32)
    svc = _jax_service("e2lsh", 8, 6)
    svc.add(list(range(32)), embeddings=pts[:32])
    svc.add(list(range(32, 64)), embeddings=pts[32:])
    want["frontend_placement"] = [svc.search(None, k=3, embeddings=pts[:3] + 0.25)[0]]
    return want


# ---------------------------------------------------------------------------
# The sharded LM cases: the reference's side
# ---------------------------------------------------------------------------

def _flat_tree(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _lm_inputs(out_dir: str) -> dict:
    """Write what the ranks' LM cases read -- the reference's weights (the
    inert leaves perturbed, as the parity tests do) and batch in
    `lm_inputs.npz`, a reference checkpoint in `lm_ref_ckpt/` -- and return
    the reference's single-device losses."""
    import dataclasses

    import jax

    from repro.checkpoint import checkpointer as jckpt
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
    from repro.models.registry import get_api as jget_api
    from repro.models.registry import get_config as jget_config
    from repro.train import step as jtsl
    from test_torch_models import reference_tree

    flat = {}
    trees = {arch: reference_tree(arch) for arch in LM_STEP_ARCHS}
    for arch, tree in trees.items():
        flat.update(_flat_tree(tree, f"tree/{arch}"))
    jcfg = jget_config(LM_ARCH)
    batch = JSyntheticTokens(jcfg, JDataConfig(global_batch=LM_BATCH, seq_len=LM_SEQ)).batch(0)
    flat["batch/tokens"] = np.asarray(batch["tokens"])
    japi = jget_api(jcfg)
    state = jtsl.init_state(jcfg, japi, jax.random.PRNGKey(0), jtsl.TrainHParams())
    jckpt.save(os.path.join(out_dir, "lm_ref_ckpt"), 3, state, extra=dict(data_step=3))
    tmp = os.path.join(out_dir, "lm_inputs.tmp.npz")
    np.savez(tmp, **flat)
    os.rename(tmp, os.path.join(out_dir, "lm_inputs.npz"))
    losses = {}
    for compute in ("bfloat16", "float32"):
        c = dataclasses.replace(jcfg, compute_dtype=compute)
        fn = jtsl.make_loss_fn(c, jget_api(c), jtsl.TrainHParams(remat=False))
        losses[compute] = float(jax.jit(lambda w, b: fn(w, b)[0])(trees[LM_ARCH], batch))
    return dict(losses=losses, tree=trees[LM_ARCH])


_SHARD_MAP_CODE = """
import json, sys
import jax, numpy as np
from repro.launch import sharding as jsh
from repro.launch.mesh import make_mesh
from repro.models.registry import get_api, get_config
cfg = get_config(sys.argv[2])
shapes = jax.eval_shape(lambda: get_api(cfg).init_params(cfg, jax.random.PRNGKey(0)))
out = {}
for name, dims in json.loads(sys.argv[3]).items():
    mesh = make_mesh(tuple(dims), ("data", "model"))
    coord = {d.id: [int(c) for c in np.argwhere(mesh.devices == d)[0]] for d in mesh.devices.flat}
    leaves = jax.tree_util.tree_leaves_with_path(jsh.params_shardings(shapes, mesh, True),
                                                 is_leaf=lambda x: hasattr(x, "spec"))
    sds = dict((jax.tree_util.keystr(p), l) for p, l in jax.tree_util.tree_leaves_with_path(shapes))
    for path, sh in leaves:
        key = "/".join(str(k.key) for k in path)
        idx = sh.devices_indices_map(sds[jax.tree_util.keystr(path)].shape)
        out.setdefault(name, {})[key] = {
            ",".join(map(str, coord[d.id])): [[s.start, s.stop] for s in sl]
            for d, sl in idx.items()}
json.dump(out, open(sys.argv[1], "w"))
"""


def _start_shard_map(out_dir: str):
    """The reference's shard of every parameter on each device of an
    8-device mesh (a subprocess: jax fixes its device count at start)."""
    import json

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, _HERE]), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    path = os.path.join(out_dir, "shard_map.json")
    return path, subprocess.Popen(
        [sys.executable, "-c", _SHARD_MAP_CODE, path, LM_ARCH, json.dumps(LM_MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# The fixture and the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """(the port's results by rank, the main process's results, the JAX
    package's results)."""
    out_dir = tempfile.mkdtemp(prefix="torch_distributed_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, _HERE]), OMP_NUM_THREADS="1")
    code = ("import sys, test_torch_distributed as t; t._world_main(sys.argv[1])")
    proc = subprocess.Popen([sys.executable, "-c", code, out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        lm = _lm_inputs(out_dir)
        map_path, mapper = _start_shard_map(out_dir)
        want = _reference_results()
        _, map_err = mapper.communicate(timeout=TIMEOUT_S)
        assert mapper.returncode == 0, map_err[-4000:]
        with open(map_path) as f:
            lm["shard_map"] = json.load(f)
        want["lm"] = lm
        try:
            _, err = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            _, err = proc.communicate()
            pytest.fail(f"the 8-rank world ran past {TIMEOUT_S} s:\n{err[-4000:]}")
        assert proc.returncode == 0, err[-6000:]
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(N_RANKS)]
        main = dict(np.load(os.path.join(out_dir, "main.npz")))
        return ranks, main, want
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _fields(got: dict, name: str) -> list:
    return [got[f"{name}|{f}"] for f in ("ids", "counts", "threshold")]


@pytest.mark.parametrize("case", CASES)
def test_distributed_case_equals_the_reference(world, case):
    ranks, main, want = world
    mine = [main] if case == "frontend_placement" else ranks
    got = _fields(mine[0], case)
    for other in mine[1:]:                         # replicated on every rank
        for a, b in zip(got, _fields(other, case)):
            assert np.array_equal(a, b), case
    for ref in want[case]:
        for field, a in zip(("ids", "counts", "threshold"), got):
            b = np.asarray(getattr(ref, field))
            assert a.dtype == np.int32 and a.shape == b.shape, (case, field)
            assert np.array_equal(a, b), (case, field)
    if f"{case}|sims" in mine[0]:
        assert np.array_equal(mine[0][f"{case}|sims"], want[f"{case}|sims"]), case
    if f"{case}|cache" in mine[0]:
        assert mine[0][f"{case}|cache"].all(), case


def test_the_shard_order_decides_ties(world):
    """The merge's tie-break is positional (a stable sort over buffers
    stacked in shard order), so the gather's order matters: on the permuted
    meshes the buffers merged in global-rank order differ from the oracle,
    and the port's result -- stacked in shard order -- equals it."""
    ranks, _, want = world
    for name in MESHES:
        ref = want[f"permuted/{name}"][0]
        naive = _fields(ranks[0], f"permuted_naive/{name}")
        assert np.array_equal(naive[1], np.asarray(ref.counts))    # the same counts
        assert not np.array_equal(naive[0], np.asarray(ref.ids))   # other ids among ties
        assert np.array_equal(_fields(ranks[0], f"permuted/{name}")[0], np.asarray(ref.ids))


def test_spq_over_padded_shards_keeps_the_reference_quirk():
    """SPQ narrows its range from the row's least count, which a pad row's -1
    lowers: over padded data (n_objects set) it may end at threshold -1 and
    lose real candidates to the cap.  The port reproduces the reference bit
    for bit there (MINSUM, 6003 rows + 5 pad rows, k = 20: row 12 keeps 13
    of its 20 slots in both), on a one-rank gloo mesh against the
    reference's one-device mesh; SORT over the same data is exact."""
    import jax.numpy as jnp
    import torch

    from repro.core import plan as jplan
    from repro.core.types import TopKMethod as JMethod
    from repro.launch import mesh as jmesh
    from repro_torch.core import SegmentedIndex, engines
    from repro_torch.core import plan as tplan
    from repro_torch.launch import mesh as tmesh

    model = engines.get("minsum")
    raw, queries, mc = model.example(np.random.default_rng(17), 6003, 33)
    index = SegmentedIndex("minsum", max_count=mc, device="cpu")
    for a, b in zip([0, 2000, 2701, 4201, 4500], [2000, 2701, 4201, 4500, 6003]):
        index.add(raw[a:b])
    data, n = index.concat_data(pad_multiple=8)
    q = model.prepare_queries(queries, torch.device("cpu"))
    mesh, jm = tmesh.make_mesh((1,), ("data",), device="cpu"), jmesh.make_mesh((1,), ("data",))
    got = {}
    for method in ("spq", "sort"):
        kw = dict(layout="distributed", n_objects=n, mesh_axes=("data",), use_kernel=False)
        res = tplan.execute(tplan.plan_search("minsum", 20, mc, method=method, **kw), data, q,
                            mesh=mesh)
        jres = jplan.execute(jplan.plan_search("minsum", 20, mc, method=JMethod(method), **kw),
                             jnp.asarray(data.numpy()), jnp.asarray(q.numpy()), mesh=jm)
        for field in ("ids", "counts", "threshold"):
            assert np.array_equal(getattr(res, field).numpy(), np.asarray(getattr(jres, field)))
        got[method] = res
    assert int(got["spq"].threshold[12]) == -1 and int((got["spq"].ids[12] >= 0).sum()) == 13
    assert int(got["sort"].threshold[12]) == 28 and bool((got["sort"].ids >= 0).all())



# ---------------------------------------------------------------------------
# The sharded LM cases
# ---------------------------------------------------------------------------

LM_F32, LM_BF16 = 1e-4, 5e-2       # the LM parity tolerances (float32, bfloat16)


@pytest.mark.parametrize("case", LM_CASES)
def test_sharded_lm_case(world, case):
    """See `_lm_rank_cases`: every rank's result, against the reference's
    (the loss within its own 2e-2 of a sharded loss, each device's shard)
    and against the port's unsharded run on the same rank."""
    ranks, _, want = world
    lm = want["lm"]
    kind, *rest = case.split("/")
    name = rest[-1]
    for r, got in enumerate(ranks):
        if kind == "loss":
            sharded16, plain16 = got[f"lm/loss/{name}|bfloat16"]
            sharded32, plain32 = got[f"lm/loss/{name}|float32"]
            assert abs(sharded16 - lm["losses"]["bfloat16"]) <= 2e-2, (r, sharded16)
            assert abs(sharded32 - lm["losses"]["float32"]) <= 2e-2, (r, sharded32)
            assert abs(sharded32 - plain32) <= LM_F32, (r, sharded32, plain32)
            assert abs(sharded16 - plain16) <= LM_BF16, (r, sharded16, plain16)
        elif kind == "shards":
            coord = ",".join(map(str, got[f"lm/shards/{name}|coord"]))
            n = 0
            for key, slices in lm["shard_map"][name].items():
                full = _at_key(lm["tree"], key)
                stacked = key.split("/")[0] == "blocks"
                for layer in range(full.shape[0] if stacked else 1):
                    part = full[layer] if stacked else full
                    sl = slices[coord][1:] if stacked else slices[coord]
                    assert slices[coord][0] == [None, None] or not stacked, (key, slices[coord])
                    port_key = (f"blocks/{layer}/" + key.split("/", 1)[1]) if stacked else key
                    local = got[f"lm/shards/{name}|{port_key}"]
                    want_part = part[tuple(slice(a, b) for a, b in sl)]
                    assert local.shape == want_part.shape, (r, key, local.shape, want_part.shape)
                    assert np.array_equal(local, want_part), (r, key)
                    n += 1
            assert n > 0
        elif kind == "step":
            gn, gn0, loss, loss0 = got[f"lm/step/{rest[0]}/{name}|scalars"]
            assert abs(loss - loss0) <= LM_F32 and abs(gn - gn0) <= LM_F32 * max(1.0, gn0), \
                (r, gn, gn0, loss, loss0)
            assert float(got[f"lm/step/{rest[0]}/{name}|param_err"]) <= 2e-6, r
        elif kind == "forward":
            sharded, plain = got[f"lm/forward/{rest[0]}/{name}|loss"]
            assert abs(sharded - plain) <= LM_F32, (r, rest[0], sharded, plain)
        elif kind == "restore":
            assert got[f"lm/restore/{rest[0]}/{name}|ok"].all(), (r, case)
        elif kind == "trainer_resume":
            assert got["lm/trainer_resume/m24|ok"].all(), r
        elif kind == "decode":
            toks = got[f"lm/decode/{name}|tokens"]
            assert np.array_equal(toks[0], toks[1]), r
            step_err, prefill_err, placed = got[f"lm/decode/{name}|err"]
            # the decode step reads the bfloat16 cache: a K/V entry's last bit
            # may round the other way; the tokens are equal above
            assert prefill_err <= LM_F32 and step_err <= LM_BF16 and placed == 1.0, (r, case)


def _at_key(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[part]
    return np.asarray(node)
