"""The port's kernel layer against the JAX package's: the same numpy inputs go
through `repro.kernels.ops` (Pallas kernels in interpret mode, tile_q=8,
tile_n=128, as tests/test_kernels.py runs them), `repro.kernels.ref`, and
`repro_torch.kernels.ops` / `ref`.  Everything is integer: equality, no
tolerance.  On the CPU the port's wrappers take their plain PyTorch versions
(the tensors lie on the CPU); the CUDA kernels themselves are held against
the same plain versions on the card by tests/test_torch_gpu.py (marked `gpu`)
and by chip_smoke.py."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import build, common, ops, ref
from repro_torch.kernels.cpq_hist import MAX_BINS, cpq_hist, cpq_hist_plain
from repro_torch.kernels.match_count import match_count, match_count_plain

SHAPES = [(1, 5, 3), (3, 130, 17), (8, 300, 64), (5, 257, 33)]  # (Q, N, m)
HIST_CASES = [(1, 5, 3), (8, 300, 64), (5, 257, 17), (3, 130, 0)]  # (Q, N, max_count)


@pytest.mark.parametrize("q,n,m", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_match_count_equals_reference(q, n, m, dtype, rng):
    d = rng.integers(0, 9, size=(n, m)).astype(dtype)
    s = rng.integers(0, 9, size=(q, m)).astype(dtype)
    got = ops.match_count(torch.from_numpy(d), torch.from_numpy(s))
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, n)
    kernel = np.asarray(jops.match_count(jnp.asarray(d), jnp.asarray(s), tile_q=8, tile_n=128))
    oracle = np.asarray(jref.match_eq(jnp.asarray(d.astype(np.int32)),
                                      jnp.asarray(s.astype(np.int32))))
    assert np.array_equal(got.numpy(), kernel)
    assert np.array_equal(got.numpy(), oracle)
    assert np.array_equal(ref.match_eq(torch.from_numpy(d), torch.from_numpy(s)).numpy(), oracle)


def test_match_count_negative_and_extreme_values(rng):
    """No sentinel survives in the port (the TPU wrapper pads with -1/-2):
    those values are ordinary signatures and must count as matches."""
    vals = np.array([-2, -1, 0, 1, np.iinfo(np.int32).min, np.iinfo(np.int32).max], np.int32)
    d = rng.choice(vals, size=(67, 9)).astype(np.int32)
    s = rng.choice(vals, size=(4, 9)).astype(np.int32)
    got = ops.match_count(torch.from_numpy(d), torch.from_numpy(s)).numpy()
    want = (s[:, None, :] == d[None, :, :]).sum(-1)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jref.match_eq(jnp.asarray(d), jnp.asarray(s))))


@pytest.mark.parametrize("q,n,max_count", HIST_CASES)
def test_cpq_hist_equals_reference(q, n, max_count, rng):
    # -1 (the pad mask's fill) and values past max_count must match no bin
    c = rng.integers(-1, max_count + 3, size=(q, n)).astype(np.int32)
    c[:, ::7] = -1
    got = ops.cpq_hist(torch.from_numpy(c), max_count)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, max_count + 1)
    kernel = np.asarray(jops.cpq_hist(jnp.asarray(c), max_count, tile_q=8, tile_n=128))
    oracle = np.asarray(jref.cpq_hist(jnp.asarray(c), max_count + 1))
    assert np.array_equal(got.numpy(), kernel)
    assert np.array_equal(got.numpy(), oracle)
    assert np.array_equal(ref.cpq_hist(torch.from_numpy(c), max_count + 1).numpy(), oracle)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int64])
def test_cpq_hist_casts_narrow_counts(dtype, rng):
    c = rng.integers(0, 20, size=(3, 200)).astype(dtype)
    got = ops.cpq_hist(torch.from_numpy(c), 19).numpy()
    want = np.asarray(jops.cpq_hist(jnp.asarray(c.astype(np.int32)), 19, tile_q=8, tile_n=128))
    assert np.array_equal(got, want)


def test_plain_versions_stand_beside_the_wrappers(rng):
    """On CPU tensors a wrapper is its plain version."""
    d = torch.from_numpy(rng.integers(0, 5, size=(40, 11)).astype(np.int32))
    s = torch.from_numpy(rng.integers(0, 5, size=(3, 11)).astype(np.int32))
    counts = match_count(d, s)
    assert torch.equal(counts, match_count_plain(d, s))
    assert torch.equal(cpq_hist(counts, 11), cpq_hist_plain(counts, 11))
    assert MAX_BINS * 4 <= 227 * 1024


def test_cpu_path_counts_no_launch(rng):
    common.reset_launch_counts()
    d = torch.from_numpy(rng.integers(0, 5, size=(40, 11)).astype(np.int32))
    ops.cpq_hist(ops.match_count(d, d[:3]), 11)
    assert common.launch_counts() == {}
    common.note_launch("match_count")
    common.note_launch("match_count")
    counts = common.launch_counts()
    assert counts == {"match_count": 2}
    counts["match_count"] = 99                     # a copy, not the live table
    assert common.launch_counts() == {"match_count": 2}
    common.reset_launch_counts()
    assert common.launch_counts() == {}


@pytest.mark.parametrize("make,exc", [
    (lambda: torch.zeros((4, 3), dtype=torch.int64), TypeError),
    (lambda: torch.zeros((4, 3), dtype=torch.float32), TypeError),
    (lambda: torch.zeros((4,), dtype=torch.int32), ValueError),
    (lambda: torch.zeros((6, 4), dtype=torch.int32)[:, ::2], ValueError),
    (lambda: np.zeros((4, 3), np.int32), TypeError),
], ids=["int64", "float32", "rank1", "strided", "numpy"])
def test_check_operand_refuses_what_a_kernel_cannot_read(make, exc):
    with pytest.raises(exc):
        common.check_operand("x", make(), 2, torch.device("cpu"))


def test_check_operand_and_status():
    common.check_operand("x", torch.zeros((4, 3), dtype=torch.int32), 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        common.check_operand("x", torch.zeros((4, 3), dtype=torch.int32), 2,
                             torch.device("meta"))
    common.check_status("k", 0)
    with pytest.raises(RuntimeError, match="error 9"):
        common.check_status("k", 9)


def test_every_c_entry_is_in_a_source_and_bound():
    """build.load() binds argtypes by name: each name must be an extern "C"
    entry of exactly one source under csrc/."""
    srcs = build.sources()
    assert [p.name for p in srcs] == ["cosine_count.cu", "cpq_compact.cu", "cpq_hist.cu",
                                      "ip_count.cu",
                                      "match_count.cu", "minsum_count.cu",
                                      "packed_cosine.cu", "packed_tanimoto.cu",
                                      "range_count.cu", "tanimoto_count.cu"]
    entries = []
    for p in srcs:
        entries += re.findall(r'extern "C" int (\w+)\(', p.read_text())
    assert sorted(entries) == ["repro_cosine_count", "repro_cosine_count_loader",
                               "repro_cpq_compact", "repro_cpq_compact_plan",
                               "repro_cpq_hist", "repro_ip_count", "repro_ip_count_loader",
                               "repro_match_count", "repro_match_count_q32",
                               "repro_minsum_count",
                               "repro_minsum_count_dense", "repro_minsum_count_row_limit",
                               "repro_minsum_csr",
                               "repro_minsum_nnz",
                               "repro_packed_cosine_count", "repro_packed_cosine_topk",
                               "repro_packed_cosine_topk_n1024",
                               "repro_packed_cosine_topk_n1024_plan",
                               "repro_packed_cosine_topk_plan",
                               "repro_packed_tanimoto_count", "repro_packed_tanimoto_topk",
                               "repro_packed_tanimoto_topk_n1024",
                               "repro_packed_tanimoto_topk_n1024_plan",
                               "repro_packed_tanimoto_topk_plan", "repro_range_count",
                               "repro_tanimoto_count", "repro_tanimoto_count_q32"]
    loader = open(build.__file__).read()
    for name in entries:
        assert f"lib.{name}.argtypes" in loader and f"lib.{name}.restype" in loader
    assert "compute_90a" in " ".join(build.NVCC_FLAGS)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "nothing-built")
    monkeypatch.setattr(build, "find_nvcc",
                        lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such architecture' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no such architecture"):
        build.build()
    assert not list((tmp_path / "b").glob("*.so"))
