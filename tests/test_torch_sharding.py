"""The port's sharding policy (`repro_torch.launch.sharding`), its cell shapes
(`repro_torch.launch.shapes`) and its activation hints
(`repro_torch.models.partition`) against the JAX package's, in one process
and without a process group.

For all 20 arch ids, on the axis shapes (16, 16), (2, 16, 16), (2, 4),
(4, 2), (1, 4) and (1, 1), with `use_tp` True and False: every parameter
leaf's spec equals the reference's `PartitionSpec` minus its stack entries,
and its per-rank shard shape equals `NamedSharding(AbstractMesh(...), P)
.shard_shape` minus its stack dims (the port's shapes from `FakeTensorMode`,
the reference's from `jax.eval_shape`); the same for the batch and cache
specs of every arch x `SHAPES`.  The multi-rank layouts (DTensor's nesting
of a dim over several mesh axes, each rank's shard) are held in
tests/test_torch_distributed.py's 8-rank world.  `repro.launch.dryrun` is
not imported: it sets XLA_FLAGS at import."""
import functools
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import sharding as jsh
from repro.launch import shapes as jshapes
from repro.models import partition as jpart
from repro.models.registry import get_api as jget_api
from repro.models.registry import get_config as jget_config
from repro.models.registry import list_archs as jlist_archs
from repro_torch.launch import dryrun, shapes, sharding
from repro_torch.models import partition
from repro_torch.models.registry import get_api, get_config, list_archs

AXES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
        ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
        ((1, 4), ("data", "model")), ((1, 1), ("data", "model"))]
AXES_IDS = ["x".join(map(str, s)) for s, _ in AXES]
ARCHS = list_archs()


def test_the_port_registers_the_reference_archs():
    assert ARCHS == sorted(jlist_archs()) and len(ARCHS) == 20


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(the port's parameter tree as meta tensors, the reference's
    eval_shape tree)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jtree = jax.eval_shape(lambda: jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    return shapes.param_specs(cfg, get_api(cfg)), jtree


def _walk(tree, path=(), idx=()):
    """(dict keys, list positions, leaf) over a port tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], path + (k,), idx)
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _walk(x, path, idx + (i,))
    else:
        yield path, idx, tree


def _at(tree, path):
    return functools.reduce(lambda t, k: t[k], path, tree)


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shards_equal_the_reference(arch, axes):
    port_tree, jtree = _shapes(arch)
    shape, names = axes
    mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    leaves = list(_walk(port_tree))
    for use_tp in (True, False):
        specs = [s for _, _, s in _walk(sharding.params_specs(port_tree, sizes, use_tp))]
        jsharded = jsh.params_shardings(jtree, mesh, use_tp)
        assert len(specs) == len(leaves)
        for (path, idx, leaf), spec in zip(leaves, specs):
            jleaf, jsharding = _at(jtree, path), _at(jsharded, path)
            jspec, stack = tuple(jsharding.spec), len(idx)
            assert tuple(jleaf.shape[stack:]) == tuple(leaf.shape), (arch, path)
            assert all(e is None for e in jspec[:stack]), (arch, path, jspec)
            assert spec == jspec[stack:], (arch, path, use_tp, spec, jspec)
            assert dryrun.shard_shape(tuple(leaf.shape), spec, sizes) == \
                tuple(jsharding.shard_shape(jleaf.shape)[stack:]), (arch, path, use_tp)
        assert len({p for p, _, _ in leaves}) == len(jax.tree_util.tree_leaves(jtree))


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, axes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, names = axes
    mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    for name, spec in shapes.SHAPES.items():
        jspec = jshapes.SHAPES[name]
        for use_tp in (True, False):
            batch = shapes.input_specs(cfg, spec)
            jbatch = jshapes.input_specs(jcfg, jspec)
            got = sharding.batch_specs(batch, sizes, use_tp)
            want = jsh.batch_shardings(jbatch, mesh, use_tp)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == tuple(want[k].spec), (arch, name, k, use_tp)
                assert dryrun.shard_shape(tuple(batch[k].shape), got[k], sizes) == \
                    want[k].shard_shape(jbatch[k].shape)
            tok = {"t": shapes.token_specs(cfg, spec)}
            jtok = jsh.batch_shardings({"t": jshapes.token_specs(jcfg, jspec)}, mesh, use_tp)
            assert sharding.batch_specs(tok, sizes, use_tp)["t"] == tuple(jtok["t"].spec)
        if spec.kind != "decode" or not shapes.cell_supported(cfg, spec)[0]:
            continue
        cache = shapes.cache_specs(cfg, spec)
        jcache = jshapes.cache_specs(jcfg, jspec)
        got = sharding.cache_specs(cfg, cache, sizes)
        want = jsh.cache_shardings(jcfg, jcache, mesh)
        assert sorted(got) == sorted(want), (arch, name)
        for k in want:
            assert got[k] == tuple(want[k].spec), (arch, name, k)
            assert dryrun.shard_shape(tuple(cache[k].shape), got[k], sizes) == \
                want[k].shard_shape(jcache[k].shape), (arch, name, k)


def _jdtype(t):
    return jnp.dtype(str(t.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shapes_and_skips_equal_the_reference(arch):
    """`input_specs`, `token_specs` and `cache_specs` (shape and dtype, on the
    meta device: nothing allocated) and `cell_supported` with its reason."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        jspec = jshapes.SHAPES[name]
        assert (spec.kind, spec.seq_len, spec.global_batch) == \
            (jspec.kind, jspec.seq_len, jspec.global_batch)
        assert shapes.cell_supported(cfg, spec) == jshapes.cell_supported(jcfg, jspec)
        pairs = [(shapes.input_specs(cfg, spec), jshapes.input_specs(jcfg, jspec)),
                 ({"t": shapes.token_specs(cfg, spec)}, {"t": jshapes.token_specs(jcfg, jspec)})]
        if spec.kind == "decode":
            pairs.append((shapes.cache_specs(cfg, spec), jshapes.cache_specs(jcfg, jspec)))
        for got, want in pairs:
            assert sorted(got) == sorted(want), (arch, name)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), (arch, name, k)
                assert _jdtype(got[k]) == want[k].dtype, (arch, name, k)


def test_param_specs_allocate_nothing_and_match_eval_shape():
    """grok-1's 316 G parameters as meta tensors, leaf for leaf the shapes
    and dtypes of the reference's eval_shape (layers stacked)."""
    port, jtree = _shapes("grok-1-314b")
    for path, idx, leaf in _walk(port):
        jleaf = _at(jtree, path)
        assert leaf.device.type == "meta"
        assert tuple(jleaf.shape) == (len(port[path[0]]),) * len(idx) + tuple(leaf.shape)
        assert _jdtype(leaf) == jleaf.dtype


ROLES = ["dp", "tp", "dpt", "rep", None]
DIMS = [1, 2, 3, 4, 6, 8, 15, 16, 24, 32, 60, 256, 512]
RESOLVE_AXES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
                {"data": 2, "model": 4}, {"data": 4, "model": 2}, {"data": 1, "model": 4},
                {"data": 1, "model": 1}, {"data": 8}]


@pytest.mark.parametrize("use_tp", [True, False])
def test_resolve_equals_the_reference_on_a_grid(use_tp):
    for axes, role, dim in itertools.product(RESOLVE_AXES, ROLES, DIMS):
        with jpart.tp_policy(use_tp), partition.tp_policy(use_tp):
            assert partition._resolve(role, dim, axes) == jpart._resolve(role, dim, axes), \
                (axes, role, dim)


def test_hint_without_a_mesh_returns_its_input():
    x = torch.zeros(4, 6, 8)
    assert partition._mesh_axes() is None
    assert partition.hint(x, "dp", "tp", None) is x
    assert partition.split_ready(x, -1, 3) is x
    assert partition.replicate_operand(x) is x
    assert partition.keep_grad_layout(x) is x
    with partition.tp_policy(False):
        assert partition.hint(x, "dp", None, "tp") is x


def test_placements_follow_the_mesh_order():
    """A spec becomes one placement a mesh dim, in the mesh's order; a dim
    over ("data", "model") is Shard on both where both split it, and on the
    one of size > 1 (the last, where all are of size 1) otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    axes = {"pod": 2, "data": 16, "model": 16}
    assert partition.placements((("data", "model"), None), axes) == \
        [Replicate(), Shard(0), Shard(0)]
    assert partition.placements((None, "model", ("pod", "data")), axes) == \
        [Shard(2), Shard(2), Shard(1)]
    assert partition.placements((), axes) == [Replicate()] * 3
    assert partition.placements((("data", "model"), None), {"data": 1, "model": 4}) == \
        [Replicate(), Shard(0)]
    assert partition.placements((("data", "model"), None), {"data": 1, "model": 1}) == \
        [Replicate(), Shard(0)]
    assert partition.placements((None, ("pod", "data"), "model"),
                                {"pod": 2, "data": 1, "model": 1}) == \
        [Shard(1), Replicate(), Shard(2)]
    with pytest.raises(ValueError, match="two dims"):
        partition.placements(("data", "data"), axes)
    with pytest.raises(ValueError, match="not in"):
        partition.placements(("pod",), {"data": 2, "model": 2})


def test_a_list_level_the_reference_does_not_stack_raises():
    with pytest.raises(ValueError, match="list levels"):
        sharding.params_specs({"embed": [torch.empty(4, 4, device="meta")]},
                              {"data": 2, "model": 2})


@pytest.mark.parametrize("compress", [False, True])
def test_state_specs_share_the_parameters_specs(compress):
    """params, m, v (and compress_error when compression is on) take the
    parameters' specs; the step is replicated."""
    from repro_torch.train import step as tsl

    port_tree, _ = _shapes("zamba2-2.7b-smoke")
    sizes = {"data": 2, "model": 4}
    specs = sharding.params_specs(port_tree, sizes, True)
    state = tsl.TrainState(port_tree, None, port_tree if compress else None)
    got = sharding.state_specs(state, specs)
    assert got.params is specs and got.opt.m is specs and got.opt.v is specs
    assert got.opt.step == ()
    assert (got.compress_error is specs) if compress else got.compress_error is None


def test_sharded_scope_without_a_mesh_is_empty():
    with partition.sharded_scope(None):
        assert partition._mesh_axes() is None
