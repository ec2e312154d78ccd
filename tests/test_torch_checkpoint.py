"""`repro_torch.checkpoint` and `repro_torch.train.trainer` on the CPU: the
reference's checkpoint tests (tests/test_checkpoint.py) on the port, with
the resume held bit for bit; `params_to_numpy` as the inverse of
`params_from_numpy`; a consistent cut under an asynchronous save; the
reference's on-disk layout read by each package from the other's
checkpoints; bfloat16 leaves; the trainer's recovery; a Trainer over a
one-rank mesh's shardings; `launch/train` and `examples/train_lm`."""
import dataclasses
import os
import runpy
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro.checkpoint import checkpointer as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models.registry import get_api as jget_api, get_config as jget_config
from repro.optim import adamw as jadamw
from repro.train import step as jtsl
from repro_torch.checkpoint import checkpointer
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes, sharding
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainHParams
from repro_torch.train import step as tsl
from repro_torch.tree import leaves
from test_torch_models import PORTED

ARCH = "smollm-360m-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many small operations: one intra-op thread keeps
    them fast beside the other test workers (pytest-xdist), where a thread
    pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(hp=TrainHParams(), arch=ARCH):
    cfg = get_config(arch)
    return tsl.init_state(cfg, get_api(cfg), 0, hp, device="cpu")


def _trainer(ckpt_dir, total_steps, fail_injector=None, seed=0, async_checkpoint=False):
    cfg = get_config(ARCH)
    api = get_api(cfg)
    # hp.total_steps stays fixed across resume phases: it defines the LR
    # schedule, which must not change when a job restarts mid-run
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3), total_steps=10, warmup_steps=2)
    tc = TrainerConfig(total_steps=total_steps, ckpt_dir=ckpt_dir, ckpt_every=5,
                       log_every=5, async_checkpoint=async_checkpoint, seed=seed)
    return Trainer(cfg, api, hp, tc, DataConfig(global_batch=2, seq_len=32),
                   fail_injector=fail_injector, device="cpu")


def _all_leaves(state):
    return leaves(state.params) + leaves(state.opt.m) + leaves(state.opt.v) + \
        [state.opt.step] + leaves(state.compress_error)


def _bit_equal(a, b):
    la, lb = _all_leaves(a), _all_leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# --- the reference's five tests, on the port ---------------------------------

def test_save_restore_roundtrip(tmp_path):
    state = _state()
    checkpointer.save(str(tmp_path), 3, state, extra=dict(data_step=3))
    assert checkpointer.latest_step(str(tmp_path)) == 3
    restored, manifest = checkpointer.restore(str(tmp_path), 3, state)
    assert manifest["extra"]["data_step"] == 3 and manifest["step"] == 3
    assert manifest["n_leaves"] == 34                      # 11 params, m, v, step
    assert _bit_equal(state, restored)
    assert all(p.requires_grad for p in leaves(restored.params))
    assert restored.opt.step.dtype == torch.int32 and restored.opt.step.dim() == 0


def test_resume_bit_exact(tmp_path):
    """10 straight steps == 5 steps + save + restore + 5 steps, bit for bit
    (the reference holds it at 1e-6): parameters, moments and step."""
    t1 = _trainer(None, 10)
    t1.run()
    d = str(tmp_path / "ck")
    _trainer(d, 5).run()
    t3 = _trainer(d, 10)
    t3.run()                                               # resumes from step 5
    assert int(t3.final_state.opt.step) == 10
    assert _bit_equal(t1.final_state, t3.final_state)


def test_atomic_no_tmp_left(tmp_path):
    checkpointer.save(str(tmp_path), 1, _state())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_prune_keeps_latest(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4):
        checkpointer.save(str(tmp_path), s, state)
    checkpointer.prune(str(tmp_path), keep=2)
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [3, 4]


def test_async_checkpoint_joins(tmp_path):
    t = checkpointer.save(str(tmp_path), 7, _state(), async_=True)
    t.join()
    assert checkpointer.latest_step(str(tmp_path)) == 7


# --- the port's own -----------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """On the port's own weights: `params_to_numpy` gives the reference's
    tree (its paths, shapes and dtypes, from `jax.eval_shape` of its
    `init_params`); `params_from_numpy` of it gives the weights back bit for
    bit, and `params_to_numpy` of those the same tree."""
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    tree = api.params_to_numpy(cfg, params)
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(lambda: jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, w), (_, g) in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    restored = api.params_from_numpy(cfg, tree, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(restored), strict=True))
    again = jax.tree_util.tree_leaves(api.params_to_numpy(cfg, restored))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree), again,
                                                    strict=True))


def test_async_save_is_a_consistent_cut(tmp_path, monkeypatch):
    """The thread writes only after a train step has updated the state in
    place; the checkpoint still holds the state as it was at `save`."""
    cfg = get_config(ARCH)
    api = get_api(cfg)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10,
                      grad_compression=True)
    state = _state(hp)
    step = tsl.make_train_step(cfg, api, hp)
    batches = SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=32))
    state, _ = step(state, batches.batch(0))
    state, _ = step(state, batches.batch(1))
    before = [x.detach().clone() for x in _all_leaves(state)]
    stepped = threading.Event()
    real = checkpointer.np.savez

    def late_savez(*args, **kw):
        assert stepped.wait(60)
        return real(*args, **kw)

    monkeypatch.setattr(checkpointer.np, "savez", late_savez)
    t = checkpointer.save(str(tmp_path), 2, state, async_=True)
    state, _ = step(state, batches.batch(2))
    assert not all(torch.equal(a, b) for a, b in zip(before, _all_leaves(state)))
    stepped.set()
    t.join()
    restored, _ = checkpointer.restore(str(tmp_path), 2, state)
    assert all(torch.equal(a, b) for a, b in zip(before, _all_leaves(restored), strict=True))


def _float32(arch):
    return (dataclasses.replace(jget_config(arch), compute_dtype="float32"),
            dataclasses.replace(get_config(arch), compute_dtype="float32"))


_HP = dict(total_steps=10, warmup_steps=2, grad_compression=True)


def _npz(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_the_port_restores_and_continues_a_reference_checkpoint(tmp_path):
    """The reference trains 3 steps with compression and saves; the port
    restores every leaf bit for bit (45 keys, compress_error included) and
    trains 2 more beside the reference's 2 more: float32 within 1e-4, but
    for the int8 quantiser's float step (a q one apart, counted)."""
    jcfg, cfg = _float32(ARCH)
    japi, api = jget_api(jcfg), get_api(cfg)
    jhp = jtsl.TrainHParams(optimizer=jadamw.AdamWConfig(lr=1e-3), **_HP)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3), **_HP)
    jstate = jtsl.init_state(jcfg, japi, jax.random.PRNGKey(0), jhp)
    jstep = jax.jit(jtsl.make_train_step(jcfg, japi, jhp))
    pipe = JSyntheticTokens(jcfg, JDataConfig(global_batch=2, seq_len=32))
    for i in range(3):
        jstate, _ = jstep(jstate, pipe.batch(i))
    jckpt.save(str(tmp_path), 3, jstate, extra=dict(data_step=3))

    state, manifest = checkpointer.restore(str(tmp_path), 3, tsl.init_state(
        cfg, api, 0, hp, device="cpu"))
    assert manifest["n_leaves"] == 45 and manifest["extra"]["data_step"] == 3
    want = _npz(str(tmp_path), 3)
    got = checkpointer._flatten(state)
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)

    step = tsl.make_train_step(cfg, api, hp)
    for i in (3, 4):
        jstate, jmet = jstep(jstate, pipe.batch(i))
        state, met = step(state, pipe.batch(i))
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4
    jflat = checkpointer._flatten(jax.tree_util.tree_map(lambda x: torch.from_numpy(
        np.array(x)), dataclasses.asdict(jstate)))
    flat = checkpointer._flatten(dataclasses.asdict(state))
    assert list(flat) == list(jflat)
    flips = 0
    for k in jflat:
        d = flat[k].astype(np.float64) - jflat[k]
        if k.startswith("compress_error/"):
            # the float step: where x / scale sits on a rounding half, float32
            # noise in the gradient moves q by one, and the carried error jumps
            # by a whole step, from about +half a step to about -half
            flip = np.abs(d) > 1e-4
            flips += int(flip.sum())
            mine, theirs = flat[k][flip], jflat[k][flip]
            assert np.all(np.sign(mine) == -np.sign(theirs)), k
            assert np.all(np.minimum(np.abs(mine), np.abs(theirs)) >= 0.4 * np.abs(d[flip])), k
            d = np.where(flip, 0.0, d)
        assert float(np.abs(d).max()) <= 1e-4, k
    assert flips <= 5, flips            # this seed: 3 of 107,820 values, one in each of 3 leaves


def test_the_reference_restores_a_port_checkpoint(tmp_path):
    """The port trains 3 steps with compression and saves; the reference's
    `restore` reads it into its own template, every leaf bit for bit."""
    jcfg, cfg = _float32(ARCH)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3), **_HP)
    state = tsl.init_state(cfg, get_api(cfg), 0, hp, device="cpu")
    step = tsl.make_train_step(cfg, get_api(cfg), hp)
    pipe = SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=32))
    for i in range(3):
        state, _ = step(state, pipe.batch(i))
    checkpointer.save(str(tmp_path), 3, state, extra=dict(data_step=3))
    jtemplate = jtsl.init_state(jcfg, jget_api(jcfg), jax.random.PRNGKey(1),
                                jtsl.TrainHParams(**_HP))
    jstate, manifest = jckpt.restore(str(tmp_path), 3, jtemplate)
    assert manifest["n_leaves"] == 45
    assert int(jstate.opt.step) == 3
    mine = checkpointer._flatten(state)
    theirs = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert len(theirs) == len(mine)
    for path, leaf in theirs:
        key = jckpt._path_key(path)
        assert np.asarray(leaf).dtype == mine[key].dtype
        assert np.array_equal(np.asarray(leaf), mine[key]), key


def test_bfloat16_moments_round_trip_and_read_the_reference_bytes(tmp_path):
    """Both packages write a bfloat16 leaf as raw `|V2` items.  The port
    restores its own and the reference's bit for bit; the reference's
    `restore` cannot cast `|V2` back (a quirk of the reference the port does
    not reproduce)."""
    hp = TrainHParams(optimizer=AdamWConfig(moment_dtype="bfloat16"), warmup_steps=1)
    cfg = get_config(ARCH)
    state = _state(hp)
    state, _ = tsl.make_train_step(cfg, get_api(cfg), hp)(
        state, SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=32)).batch(0))
    assert state.opt.m["embed"].dtype == torch.bfloat16
    mine = str(tmp_path / "port")
    checkpointer.save(mine, 1, state)
    z = _npz(mine, 1)
    assert z["opt/m/embed"].dtype == np.dtype("V2") and z["params/embed"].dtype == np.float32
    restored, _ = checkpointer.restore(mine, 1, _state(hp))
    assert _bit_equal(state, restored)

    jcfg = jget_config(ARCH)
    jhp = jtsl.TrainHParams(optimizer=jadamw.AdamWConfig(moment_dtype="bfloat16"),
                            warmup_steps=1)
    jstate = jtsl.init_state(jcfg, jget_api(jcfg), jax.random.PRNGKey(0), jhp)
    jstate, _ = jax.jit(jtsl.make_train_step(jcfg, jget_api(jcfg), jhp))(
        jstate, JSyntheticTokens(jcfg, JDataConfig(global_batch=2, seq_len=32)).batch(0))
    theirs = str(tmp_path / "reference")
    jckpt.save(theirs, 1, jstate)
    assert _npz(theirs, 1)["opt/m/embed"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(theirs, 1, jstate)
    got, _ = checkpointer.restore(theirs, 1, _state(hp))
    for name in ("m", "v"):
        want = np.asarray(getattr(jstate.opt, name)["embed"]).view(np.int16)
        have = getattr(got.opt, name)["embed"]
        assert have.dtype == torch.bfloat16
        assert np.array_equal(have.view(torch.int16).numpy(), want)
    assert float(jnp.abs(jstate.opt.m["embed"]).max()) > 0


def test_trainer_recovers_from_injected_failures(tmp_path):
    """The reference's test (tests/test_fault_tolerance.py) on the port."""
    crashes = {"left": 2}

    def injector(step):
        if step == 7 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected node failure")

    cfg = get_config(ARCH)
    hp = TrainHParams(optimizer=AdamWConfig(lr=1e-3), total_steps=12, warmup_steps=2)
    tc = TrainerConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=4,
                       async_checkpoint=False)
    tr = Trainer(cfg, get_api(cfg), hp, tc, DataConfig(global_batch=2, seq_len=32),
                 fail_injector=injector, device="cpu")
    hist = tr.run()
    assert crashes["left"] == 0
    assert hist[-1]["step"] == 12
    assert np.isfinite(hist[-1]["loss"])
    assert tr.recoveries == 2
    assert checkpointer.latest_step(str(tmp_path)) == 12


def test_trainer_async_checkpoints_resume_bit_exact(tmp_path):
    """With the one-in-flight asynchronous save (joined before the next and
    at the end), a resumed run still equals a straight one bit for bit."""
    d = str(tmp_path / "ck")
    _trainer(d, 5, async_checkpoint=True).run()
    t = _trainer(d, 10, async_checkpoint=True)
    t.run()
    straight = _trainer(None, 10)
    straight.run()
    assert _bit_equal(straight.final_state, t.final_state)


def _state_shardings(mesh, hp=TrainHParams()):
    cfg = get_config(ARCH)
    pshapes = shapes.param_specs(cfg, get_api(cfg))
    psh = sharding.params_shardings(pshapes, mesh, cfg.use_tp)
    return sharding.state_shardings(
        tsl.TrainState(params=pshapes, opt=None,
                       compress_error=pshapes if hp.grad_compression else None), psh, mesh)


def _whole_leaves(state):
    return [x.full_tensor() if isinstance(x, DTensor) else x for x in _all_leaves(state)]


def test_trainer_over_shardings_equals_the_plain_trainer(tmp_path):
    """A Trainer over a one-rank gloo mesh's state shardings: every state
    leaf a DTensor on its spec's placements; 10 steps equal the plain
    Trainer's bit for bit; 5 + a checkpoint + 5 in a fresh sharded Trainer
    equal them too; the checkpoint restored with shardings equals the
    saved leaves."""
    mesh = mesh_lib.make_local_mesh(1, device="cpu")
    ssh = _state_shardings(mesh)
    plain = _trainer(None, 10)
    plain.run()

    def sharded(ckpt_dir, total):
        t = _trainer(ckpt_dir, total)
        t.shardings = ssh
        return t

    straight = sharded(None, 10)
    straight.run()
    for leaf, sh in zip(_all_leaves(straight.final_state), sharding.leaves_of(ssh)):
        assert isinstance(leaf, DTensor) and tuple(leaf.placements) == sh.placements
    assert [r["loss"] for r in straight.history] == [r["loss"] for r in plain.history]
    assert all(torch.equal(a, b) for a, b in zip(_whole_leaves(straight.final_state),
                                                 _all_leaves(plain.final_state)))
    d = str(tmp_path / "ck")
    sharded(d, 5).run()
    resumed = sharded(d, 10)
    resumed.run()
    assert all(torch.equal(a, b) for a, b in zip(_whole_leaves(resumed.final_state),
                                                 _whole_leaves(straight.final_state)))
    template = sharding.place_tree(_state(), ssh)
    restored, manifest = checkpointer.restore(d, 10, template, ssh)
    assert manifest["extra"]["data_step"] == 10
    assert all(torch.equal(a, b) for a, b in zip(_whole_leaves(restored),
                                                 _whole_leaves(resumed.final_state)))


def test_launch_train_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    hist = launch_train.main(["--arch", ARCH, "--steps", "4", "--global-batch", "2",
                              "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "2",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} over 1 devices" in out
    assert hist[-1]["step"] == 4 and np.isfinite(hist[-1]["loss"])
    assert "step      4  loss" in out
    assert checkpointer.latest_step(d) == 4


def test_launch_train_model_parallel_must_divide_the_ranks():
    """`--model-parallel` sizes the mesh's model axis: 2 does not divide one
    rank, and raises as `make_local_mesh` does."""
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        launch_train.main(["--arch", ARCH, "--model-parallel", "2", "--device", "cpu"])


def test_examples_train_lm_runs_as_a_module(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train_lm", "--device", "cpu", "--steps", "10"])
    runpy.run_module("repro_torch.examples.train_lm", run_name="__main__")
    out = capsys.readouterr().out
    assert "step    10  loss" in out and "final loss: " in out
