"""The port's dry-run (`repro_torch.launch.dryrun`): its GENIE cells against
the same arithmetic on the JAX package's `repro.core.segments.
layout_accounting` and `repro.core.engines`, for the six datasets on worlds
of 1 and 4, and its per-rank memory model against bytes computed by hand;
its LM cells against the reference's arithmetic and shard shapes
(`repro.launch.sharding` on an `AbstractMesh`), every arch x shape x mesh.  (`repro.launch.dryrun`
itself is not loaded: it sets XLA_FLAGS at import and compiles for
minutes.)"""
import functools
import json
import math

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ALL_ARCHS as JALL_ARCHS
from repro.configs.genie_datasets import DATASETS as JDATASETS
from repro.core import engines as jengines
from repro.core import segments as jsegments
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsh
from repro.models.registry import get_api as jget_api
from repro.models.registry import get_config as jget_config
from repro_torch.launch import dryrun, shapes
from repro_torch.models.registry import get_config

# the port keeps int32 where the reference chose int8 / int16, and int8 for IP
ELEMENT_BYTES = {"ocr": 4, "sift": 4, "sift_large": 4, "dblp": 4, "tweets": 1, "adult": 4}
REFERENCE_BYTES = {"ocr": 2, "sift": 1, "sift_large": 1, "dblp": 1, "tweets": 1, "adult": 4}


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("name", sorted(JDATASETS))
def test_cell_fields_equal_the_reference_arithmetic(name, world):
    ds = JDATASETS[name]
    rep = dryrun.run_genie_cell(name, world)
    width = ds.m if ds.engine != "range" else ds.dim
    sig = ELEMENT_BYTES[name]
    assert rep["element_bytes"] == sig
    assert rep["reference_element_bytes"] == REFERENCE_BYTES[name]
    n = -(-ds.n_objects // world) * world
    n_local = n // world
    q = ds.queries_per_batch
    assert (rep["n_objects"], rep["n_queries"]) == (n, q)
    assert rep["model_flops"] == float(q) * n * width
    flops = 2.0 * q * n_local * width if ds.engine == "ip" else \
        float(q) * n_local * width + float(q) * n_local
    assert rep["kernel_model"] == dict(
        flops=flops, bytes_accessed=n_local * width * sig + q * width * sig
        + 2.0 * 4 * q * n_local)
    ingest = jsegments.even_segments(ds.n_objects, 16)
    compacted = [ingest[i] + ingest[i + 1] for i in range(0, 16, 2)]
    seg = rep["segmented"]
    assert seg["pad_rows"] == n - ds.n_objects
    assert seg["ingest"] == jsegments.layout_accounting(ingest, width * sig)
    assert seg["compacted"] == jsegments.layout_accounting(compacted, width * sig)
    model = jengines.get(ds.engine)
    assert seg["signatures"] == dict(
        packed_supported=model.supports_packed, bytes_per_object_wide=width * sig,
        bytes_per_object_packed=None, ingest_packed=None, compacted_packed=None)
    plan = rep["plan"]
    assert plan["engine"] == ds.engine and plan["k"] == ds.default_k
    if world == 1:
        assert plan["layout"] == "segmented" and plan["part_rows"] == compacted
    else:
        assert plan["layout"] == "distributed" and plan["n_objects"] == ds.n_objects
        assert plan["merge"] == "collective"
    mem = rep["memory"]
    assert mem["card_bytes"] == 80 * 2**30 and "no card" in mem["card_bytes_source"]
    assert mem["fits"] == (mem["per_rank"]["peak"] <= mem["card_bytes"])
    json.dumps(rep)


@pytest.mark.parametrize("q", [256, 1024])
def test_memory_model_for_sift_by_hand(q):
    """SIFT: 4.5 M rows of 237 int32 signatures; k = 100, so a cap of 200."""
    row = 237 * 4
    small = q * row + q * 238 * 4 + 4 * q * 200 * 4
    one = dryrun.run_genie_cell("sift", 1, n_queries=q)["memory"]["per_rank"]
    counts = q * 562_500 * 4                              # one compacted segment
    # the compaction kernel keeps cap = 200 ties in shared memory: no scratch
    assert one == dict(segments=4_500_000 * row, placed=0, counts=counts, pad_mask=0,
                       compaction=0, queries=q * row,
                       histogram=q * 238 * 4, buffers=4 * q * 200 * 4,
                       peak=4_500_000 * row + counts + small)
    four = dryrun.run_genie_cell("sift", 4, n_queries=q)["memory"]["per_rank"]
    counts = q * 1_125_000 * 4                            # one rank's shard
    # DISTRIBUTED masks the shards' pad columns: a masked copy beside the counts
    assert four["placed"] == 1_125_000 * row and four["counts"] == four["pad_mask"] == counts
    assert four["peak"] == (4_500_000 + 1_125_000) * row + 2 * counts + small
    # chip_smoke.py phase 4k's cell: DISTRIBUTED on one rank, the whole
    # corpus one part, beside the service's segments (m = 238 there)
    shard = dryrun.memory_model(n_objects=4_500_000, row_bytes=238 * 4, n_queries=q,
                                part_rows=4_500_000, placed_rows=4_500_000,
                                query_bytes=238 * 4, max_count=238, cap=200, masked=True)
    counts = q * 4_500_000 * 4
    assert shard["peak"] == 2 * 4_500_000 * 238 * 4 + 2 * counts \
        + q * 238 * 4 + q * 239 * 4 + 4 * q * 200 * 4
    if q == 256:                                          # 8.6 GB of signatures + 2 C
        assert 17e9 < shard["peak"] < 19e9
    # a cap beyond the shared tie buffer takes a [Q, cap] int32 scratch
    wide = dryrun.memory_model(n_objects=10, row_bytes=4, n_queries=q, part_rows=10,
                               placed_rows=0, query_bytes=4, max_count=1, cap=10_000)
    assert wide["compaction"] == q * 10_000 * 4


def test_main_takes_the_genie_and_the_lm_cells(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "REPORT_DIR", str(tmp_path))
    dryrun.main(["--genie", "--world", "4", "--n-queries", "64"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"genie__{d}__search_64q__world4.json" for d in JDATASETS)
    assert "fits=" in capsys.readouterr().out
    dryrun.main([])                                # every LM cell, no GENIE cell
    lm = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("lm__"))
    assert lm == sorted(f"lm__{a}__{s}__{m}.json" for a in JALL_ARCHS for s in jshapes.SHAPES
                        for m in MESHES)
    assert len(lm) == 160
    rep = json.loads((tmp_path / "lm__phi3-mini-3.8b__long_500k__single.json").read_text())
    assert rep["skipped"] and rep["kind"] == "lm" and rep["mesh"] == "single"
    with pytest.raises(ValueError, match="world"):
        dryrun.run_genie_cell("sift", 2)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model")),
          "world1": ((1, 1), ("data", "model")), "world4": ((1, 4), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: jget_api(cfg).init_params(cfg, jax.random.PRNGKey(0)))


def _jbytes(tree, shardings, itemsize=None) -> int:
    """Bytes of one rank's shards of `tree` under the reference's shardings."""
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
        total += math.prod(sh.shard_shape(leaf.shape)) * (itemsize or leaf.dtype.itemsize)
    return total


def _reference_accum(shape, sizes, use_tp):
    """`repro/launch/dryrun.py::_lower_lm`'s microbatch rule."""
    dp = math.prod(sizes[a] for a in (("pod", "data") if "pod" in sizes else ("data",)))
    dp *= 1 if use_tp else sizes["model"]
    tokens_per_dev = shape.global_batch * shape.seq_len // dp
    accum = 1
    while tokens_per_dev // accum > 8192 and shape.global_batch % (2 * accum) == 0:
        accum *= 2
    return accum


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", JALL_ARCHS)
def test_lm_cell_equals_the_reference_arithmetic(arch, shape, mesh):
    """The analytic fields, accum and the moment dtype by the reference's
    rules; the per-rank params, moments, batch and cache bytes the sums of
    the reference's shard shapes; the skips and their reasons."""
    jcfg, jshape = jget_config(arch), jshapes.SHAPES[shape]
    rep = dryrun.run_lm_cell(arch, shape, mesh)
    json.dumps(rep)
    ok, reason = jshapes.cell_supported(jcfg, jshape)
    if not ok or (jshape.kind == "decode" and not jget_api(jcfg).supports_decode):
        assert rep == dict(ok=True, skipped=True, reason=reason or
                           "architecture has no decode step")
        return
    dims, names = MESHES[mesh]
    amesh, sizes = AbstractMesh(dims, names), dict(zip(names, dims))
    use_tp = jcfg.use_tp if jshape.kind == "train" else jcfg.use_tp_serve
    tokens = jshape.global_batch * (jshape.seq_len if jshape.kind != "decode" else 1)
    assert rep["use_tp"] == use_tp and not rep["skipped"]
    assert rep["param_count"] == jcfg.param_count()
    assert rep["active_param_count"] == jcfg.active_param_count()
    assert rep["tokens_per_step"] == tokens
    assert rep["model_flops"] == float((6 if jshape.kind == "train" else 2)
                                       * jcfg.active_param_count() * tokens)
    per_rank = rep["memory"]["per_rank"]
    jp = _jparams(arch)
    assert per_rank["params"] == _jbytes(jp, jsh.params_shardings(jp, amesh, use_tp))
    if jshape.kind == "decode":
        batch = {"t": jshapes.token_specs(jcfg, jshape)}
        cache = jshapes.cache_specs(jcfg, jshape)
        assert per_rank["cache"] == _jbytes(cache, jsh.cache_shardings(jcfg, cache, amesh))
    else:
        batch = jshapes.input_specs(jcfg, jshape)
    assert per_rank["batch"] == _jbytes(batch, jsh.batch_shardings(batch, amesh, use_tp))
    if jshape.kind == "train":
        accum = _reference_accum(jshape, sizes, use_tp)
        mdt = "bfloat16" if jcfg.param_count() > 100e9 else "float32"
        assert (rep["accum"], rep["moment_dtype"]) == (accum, mdt)
        assert per_rank["moments"] == 2 * _jbytes(jp, jsh.params_shardings(jp, amesh, use_tp),
                                                  2 if mdt == "bfloat16" else 4)
        assert per_rank["gradients"] == per_rank["params"] * (2 if accum > 1 else 1)
    assert per_rank["peak"] == sum(v for k, v in per_rank.items() if k != "peak")
    assert rep["memory"]["fits"] == (per_rank["peak"] <= rep["memory"]["card_bytes"])


def test_lm_collectives_by_hand():
    """smollm-360m train_4k on world4 (data 1, model 4; use_tp False, so the
    four ranks are one ZeRO group): accum 32 (262,144 tokens a rank in
    8,192-token microbatches); every 2-D weight (361,758,720 of the
    361,821,120 parameters) gathered twice a microbatch in bfloat16 and its
    float32 gradient reduce-scattered, three of four shards each; the norms
    (62,400) all-reduced over the four replicas.  phi3-mini-3.8b decode_32k
    on world4: nothing gathered (data 1; the cache's length unsharded), two
    row-parallel all-reduces a layer of [128, 1, 3072] bfloat16."""
    rep = dryrun.run_lm_cell("smollm-360m", "train_4k", "world4")
    assert rep["accum"] == 32
    shard = 361_758_720 // 4
    assert rep["collectives"] == {"all-gather": 32 * 2 * 3 * shard * 2,
                                  "reduce-scatter": 32 * 3 * shard * 4,
                                  "all-reduce": 32 * int(2 * 3 / 4 * 62_400 * 4)}
    rep = dryrun.run_lm_cell("phi3-mini-3.8b", "decode_32k", "world4")
    assert rep["collectives"] == {"all-gather": 0, "reduce-scatter": 0,
                                  "all-reduce": int(32 * 2 * 2 * 3 / 4 * 128 * 3072 * 2)}


def test_lm_memory_model_of_the_training_run_on_one_card():
    """smollm-360m at 8 x 1024 on world1 (chip_smoke.py phase 8d holds this
    model against a measured peak): the state is 1.447 GB of float32
    parameters, twice that of moments, the gradients, the [8, 1024, 49152]
    float32 logits, and the activation model."""
    rep = dryrun.lm_cell("smollm-360m", shapes.ShapeSpec("smoke", "train", 1024, 8),
                         {"data": 1, "model": 1})
    per_rank = rep["memory"]["per_rank"]
    n = 361_821_120
    assert (per_rank["params"], per_rank["moments"], per_rank["gradients"]) == (4 * n, 8 * n, 4 * n)
    assert per_rank["logits"] == 8 * 1024 * 49152 * 4 and rep["accum"] == 1
    assert per_rank["activations"] == dryrun.activation_bytes(
        get_config("smollm-360m"), "train", 8, 1024, {"data": 1, "model": 1}, False)
    assert rep["collectives"] == {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
