"""`repro_torch.optim` against `repro.optim`: the same numpy inputs, made
from a seed, through AdamW, the global-norm clip, the cosine schedule and
the int8 error-feedback compression of both packages; and the reference's
own optimizer tests (tests/test_train.py) on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.optim import AdamWConfig, AdamWState, adamw, compress, schedule


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many small operations: one intra-op thread keeps
    them fast beside the other test workers (pytest-xdist), where a thread
    pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, shapes=((7, 5), (3,), (2, 4, 3))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _max_diff(got, want):
    return max(float(np.abs(got[k].float().numpy() - np.asarray(want[k], np.float32)).max())
               for k in want)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_steps_equal_the_reference(moment_dtype):
    """Three steps on a tree (the clip active on the second), lr from the
    schedule's tensor: parameters and moments within 1e-6 (bfloat16 moments
    at their own resolution: the same roundings of the same float32
    values)."""
    cfg = dict(lr=3e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=2.0,
               moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), AdamWConfig(**cfg)
    params = _tree(0)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    jst, tst = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    assert tst.m["w0"].dtype == (torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    for i, scale in enumerate((0.1, 3.0, 0.5)):
        grads = {k: v * scale for k, v in _tree(10 + i).items()}
        lr = np.float32(0.01 * (i + 1))
        jp, jst, jn = jadamw.update({k: jnp.asarray(v) for k, v in grads.items()}, jst, jp,
                                    jcfg, jnp.asarray(lr))
        tp2, tst2, tn = adamw.update(_t(grads), tst, tp, tcfg, torch.tensor(lr))
        assert tp2 is tp and tst2 is tst                      # in place
        assert abs(float(tn) - float(jn)) <= 1e-5 * float(jn)
        assert _max_diff(tp, jp) <= 1e-6
        tol = 1e-6 if moment_dtype == "float32" else 2.0 ** -8
        for name in ("m", "v"):
            got, want = getattr(tst, name), getattr(jst, name)
            for k in want:
                w = np.asarray(want[k].astype(jnp.float32))
                assert np.all(np.abs(got[k].float().numpy() - w) <= 1e-6 + tol * np.abs(w)), \
                    (name, k)
        assert int(tst.step) == int(jst.step) == i + 1
        assert tst.step.dtype == torch.int32 and tst.step.dim() == 0


def test_global_norm_and_clip_equal_the_reference():
    rng = np.random.default_rng(3)
    for scale in (0.01, 1.0, 50.0):
        g = {k: v * scale for k, v in _tree(int(rng.integers(1 << 30))).items()}
        jn = jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()})
        tn = adamw.global_norm(_t(g))
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        jc, jcn = jadamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tc, tcn = adamw.clip_by_global_norm(_t(g), 1.0)
        assert abs(float(tcn) - float(jcn)) <= 1e-6 * float(jcn)
        assert _max_diff(tc, jc) <= 1e-6


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 250])
def test_cosine_schedule_equals_the_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = jschedule.cosine_with_warmup(jnp.int32(step), **kw)
    got = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= 1e-6 * 3e-4


def test_compression_equals_the_reference_over_eight_steps():
    """q and scale equal exactly at every step; the dequantised gradients
    and the carried error within float32 resolution."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 64), "b": (3, 17), "c": (1,)}
    jerr = jcompress.init_error({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = compress.init_error({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(8):
        g = {k: rng.standard_normal(s).astype(np.float32) * rng.uniform(0.1, 10)
             for k, s in shapes.items()}
        for k in shapes:
            jq, js, _ = jcompress.compress_tensor(jnp.asarray(g[k]), jerr[k])
            tq, ts, _ = compress.compress_tensor(torch.from_numpy(g[k]), terr[k])
            assert tq.dtype == torch.int8
            assert np.array_equal(tq.numpy(), np.asarray(jq)), k
            assert float(ts) == float(js), k
        jdeq, jerr = jcompress.apply({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tdeq, terr = compress.apply(_t(g), terr)
        assert _max_diff(tdeq, jdeq) == 0.0
        assert _max_diff(terr, jerr) <= 1e-6


def test_compression_takes_one_scale_over_the_layers_of_a_stacked_leaf():
    """The reference's leaf `blocks/w` is [L, ...]: one scale over every
    layer.  The port's list of per-layer tensors gets the same scale, and
    the same q, dequantised gradients and errors, bit for bit."""
    rng = np.random.default_rng(9)
    stacked = (rng.standard_normal((3, 6, 5)) * np.array([0.01, 1.0, 20.0])[:, None, None]) \
        .astype(np.float32)
    head = rng.standard_normal((4,)).astype(np.float32)
    jdeq, jerr = jcompress.apply({"blocks": {"w": jnp.asarray(stacked)}, "head": jnp.asarray(head)},
                                 {"blocks": {"w": jnp.zeros((3, 6, 5))}, "head": jnp.zeros(4)})
    grads = {"blocks": [{"w": torch.from_numpy(stacked[i].copy())} for i in range(3)],
             "head": torch.from_numpy(head)}
    deq, err = compress.apply(grads, compress.init_error(grads))
    for i in range(3):
        assert np.array_equal(deq["blocks"][i]["w"].numpy(), np.asarray(jdeq["blocks"]["w"][i]))
        assert np.array_equal(err["blocks"][i]["w"].numpy(), np.asarray(jerr["blocks"]["w"][i]))
    assert np.array_equal(deq["head"].numpy(), np.asarray(jdeq["head"]))
    # the small layer quantises to few levels under the shared scale
    assert len(np.unique(deq["blocks"][0]["w"].numpy())) <= 3


def test_compress_rounds_half_to_even():
    """x / scale exactly on .5 rounds to the even integer, as jnp.round."""
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, scale, _ = compress.compress_tensor(g, torch.zeros(6))
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    jq, _, _ = jcompress.compress_tensor(jnp.asarray(g.numpy()), jnp.zeros(6))
    assert q.tolist() == np.asarray(jq).tolist()


# --- the reference's own tests (tests/test_train.py), on the port ------------

def test_adamw_against_hand_computed_step():
    """One AdamW step == hand-computed reference on a tiny tree."""
    params = {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5])}
    grads = {"w": torch.tensor([0.1, 0.2]), "b": torch.tensor([-0.3])}
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=1e9)
    st = adamw.init(params, cfg)
    want = {}
    for k in params:
        g = grads[k].double().numpy()
        mh, vh = 0.1 * g / (1 - 0.9), 0.01 * g * g / (1 - 0.99)
        want[k] = params[k].double().numpy() - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    new_p, st2, _ = adamw.update(grads, st, params, cfg)
    for k in params:
        assert np.abs(new_p[k].numpy() - want[k]).max() < 1e-5
    assert isinstance(st2, AdamWState) and int(st2.step) == 1


def test_clip_by_global_norm():
    clipped, norm = adamw.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert abs(float(norm) - 20.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_compression_error_feedback(rng):
    """Dequantised grads + carried error == original grads (lossless in sum)."""
    err = compress.init_error({"w": torch.zeros(64, 64)})
    total_true = np.zeros((64, 64))
    total_sent = np.zeros((64, 64))
    for _ in range(8):
        gi = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
        total_true += gi["w"].numpy()
        deq, err = compress.apply(gi, err)
        total_sent += deq["w"].numpy()
    resid = np.abs(total_sent + err["w"].numpy() - total_true).max()
    assert resid < 1e-3, resid


def test_cosine_schedule():
    lr = [float(schedule.cosine_with_warmup(torch.tensor(s, dtype=torch.int32), peak_lr=1.0,
                                            warmup_steps=10, total_steps=100))
          for s in (0, 10, 100)]
    assert lr[0] == 0.0
    assert abs(lr[1] - 1.0) < 1e-5
    assert lr[2] == pytest.approx(0.1, abs=1e-5)


def test_adamw_state_is_on_the_parameters_device():
    st = adamw.init({"w": torch.zeros(3, device="cpu")})
    assert st.step.device.type == "cpu" and st.m["w"].device.type == "cpu"
