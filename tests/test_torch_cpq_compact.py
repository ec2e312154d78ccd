"""The arithmetic of the c-PQ compaction kernel
(src/repro_torch/kernels/csrc/cpq_compact.cu), checked on the CPU.  The CUDA
kernel runs only on the card (tests/test_torch_gpu.py, chip_smoke.py); here a
numpy model of how it ranks -- the peeled head, the int4 groups in the order
its index formula gives them, the tail; one block a row with its tie buffer,
or a row cut into chunks counted first -- is held against the port's plain
version and the JAX package's `repro.core.cpq._compact_candidates` on the
same seeded inputs.  Everything is integer-valued: equality, no tolerance."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpq as jcpq
from repro_torch.core import cpq
from repro_torch.kernels import build, common
from repro_torch.kernels.cpq_compact import SMEM_TIES, cpq_compact, cpq_compact_plain

SRC = (build.CSRC_DIR / "cpq_compact.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SRC)}
UNWRITTEN = -7


def kernel_order(length: int, misalign: int, threads: int, loads: int) -> np.ndarray:
    """Positions of a range of `length` counts (its first `misalign` int32s
    past a 16-byte boundary) in the order the kernel ranks them: the head
    before the boundary, then, step by step, warp w, slice k, lane l, the
    four counts of group step * threads * loads + w * 32 * loads + k * 32 + l
    (the kernel's index formula), then the tail."""
    head = min(length, (4 - misalign) % 4)
    groups = (length - head) // 4
    step, wg = threads * loads, 32 * loads
    s, w, k, lane = np.meshgrid(np.arange(-(-groups // step)), np.arange(threads // 32),
                                np.arange(loads), np.arange(32), indexing="ij")
    g = (s * step + w * wg + k * 32 + lane).ravel()
    g = g[g < groups]
    body = head + 4 * g[:, None] + np.arange(4)[None, :]
    return np.concatenate([np.arange(head), body.ravel(), np.arange(head + 4 * groups, length)])


def walk(row, start, end, thr, misalign, ns, nt, threads, loads):
    """One block's walk over [start, end) of a row whose first count lies
    `misalign` int32s past a 16-byte boundary: (ids in rank order, counts,
    strict mask, tie mask, strict ranks, tie ranks, totals at the end)."""
    ids = start + kernel_order(end - start, (misalign + start) % 4, threads, loads)
    v = row[ids]
    strict, tie = v > thr, v == thr
    rs = ns + np.cumsum(strict) - strict
    rt = nt + np.cumsum(tie) - tie
    return ids, v, strict, tie, rs, rt, ns + int(strict.sum()), nt + int(tie.sum())


def _put(out_ids, out_vals, writes, slots, ids, vals):
    out_ids[slots], out_vals[slots] = ids, vals
    np.add.at(writes, slots, 1)


def rows_model(row, thr, cap, misalign, threads, loads):
    """One block owns the row: strict entries to their slot, the first cap
    ties to the tie buffer, copied after n_strict at the end, -1 after them.
    Returns (ids, vals, the writes a slot took)."""
    out_ids, out_vals = np.full(cap, UNWRITTEN), np.full(cap, UNWRITTEN)
    writes = np.zeros(cap, dtype=np.int64)
    ids, v, strict, tie, rs, rt, ns, nt = walk(row, 0, len(row), thr, misalign, 0, 0,
                                              threads, loads)
    keep = strict & (rs < cap)
    _put(out_ids, out_vals, writes, rs[keep], ids[keep], v[keep])
    ties = np.full(cap, UNWRITTEN)
    keep = tie & (rt < cap)
    ties[rt[keep]] = ids[keep]
    slots = np.arange(ns, cap)
    j = slots - ns
    has = j < nt
    _put(out_ids, out_vals, writes, slots, np.where(has, ties[np.minimum(j, cap - 1)], -1),
         np.where(has, thr, -1))
    return out_ids, out_vals, writes


def chunks_model(row, thr, cap, misalign, threads, loads, chunk):
    """The row cut into chunks of `chunk` counts: a counting pass, then each
    chunk writes from the offsets of the chunks before it, ties straight to
    slot n_strict + rank; chunk 0 writes -1 past the row's entries."""
    n = len(row)
    starts = range(0, n, chunk)
    totals = [walk(row, a, min(a + chunk, n), thr, misalign, 0, 0, threads, loads)[6:]
              for a in starts]
    n_strict = sum(s for s, _ in totals)
    n_ties = sum(u for _, u in totals)
    first_tie = min(n_strict, cap)
    out_ids, out_vals = np.full(cap, UNWRITTEN), np.full(cap, UNWRITTEN)
    writes = np.zeros(cap, dtype=np.int64)
    bs = bt = 0
    for c, a in enumerate(starts):
        ids, v, strict, tie, rs, rt, _, _ = walk(row, a, min(a + chunk, n), thr, misalign,
                                                 bs, bt, threads, loads)
        keep = strict & (rs < cap)
        _put(out_ids, out_vals, writes, rs[keep], ids[keep], v[keep])
        keep = tie & (rt < cap - first_tie)
        _put(out_ids, out_vals, writes, first_tie + rt[keep], ids[keep], v[keep])
        bs, bt = bs + totals[c][0], bt + totals[c][1]
    slots = np.arange(min(cap, n_strict + n_ties), cap)
    _put(out_ids, out_vals, writes, slots, -1, -1)
    return out_ids, out_vals, writes


def plan_model(n: int, q: int, fit: int) -> tuple[int, int]:
    """(chunk, n_chunks) of the kernel's cut (compact_plan) where the card
    holds `fit` blocks of the row kernel at once."""
    c = 1
    if 2 * q < fit:
        c = min(-(-fit // q), -(-n // MIN_CHUNK))
    size = -(-n // c)
    size = -(-size // 4) * 4
    return size, -(-n // size)


assert re.search(r"constexpr long long STEP = THREADS \* LOADS;", SRC)
assert re.search(r"constexpr long long MIN_CHUNK = 4 \* STEP \* 4;", SRC)
MIN_CHUNK = 4 * CONST["THREADS"] * CONST["LOADS"] * 4


def _counts(rng, q, n, max_count, pad):
    """Skewed counts in [0, max_count] (a third of them one value), the last
    `pad` columns -1 as the pad mask leaves them."""
    c = rng.integers(0, max_count + 1, size=(q, n)).astype(np.int32)
    c[:, ::3] = max_count // 3
    if pad:
        c[:, -pad:] = -1
    return c


def _thresholds(counts, max_count, cap):
    """A threshold a row, in turn: -1, 0, the middle, max_count, the Gate's
    for k = cap // 2, one so low that the strict entries exceed cap, and the
    most common value (its ties overflow cap)."""
    q = counts.shape[0]
    hist = cpq.count_histogram(torch.from_numpy(counts), max_count)
    _, gate = cpq.audit_threshold(hist, max(1, cap // 2))
    kinds = [-1, 0, max_count // 2, max_count, None, 1, max_count // 3]
    thr = np.array([kinds[r % len(kinds)] if kinds[r % len(kinds)] is not None
                    else int(gate[r]) for r in range(q)], dtype=np.int32)
    return thr


@pytest.mark.parametrize("n", [150, 4097, 5002, 20003])
@pytest.mark.parametrize("cut", ["rows", "chunks"])
def test_kernel_rank_model_equals_plain_version_and_reference(n, cut):
    """At 64 threads and 2 loads a step (steps of 512 counts), rows of
    N % 4 in {0, 1, 2, 3}, so row q starts (q * N) % 4 int32s past a 16-byte
    boundary; every slot is written once, and the slots equal the plain
    version's and the reference's."""
    rng = np.random.default_rng(n + (cut == "chunks"))
    q, max_count, cap, pad = 7, 40, 200, 5
    counts = _counts(rng, q, n, max_count, pad)
    thr = _thresholds(counts, max_count, cap)
    want_ids, want_vals = cpq_compact_plain(torch.from_numpy(counts), torch.from_numpy(thr), cap)
    j_ids, j_vals = jcpq._compact_candidates(jnp.asarray(counts), jnp.asarray(thr), cap)
    assert np.array_equal(np.asarray(j_ids), want_ids.numpy())
    assert np.array_equal(np.asarray(j_vals), want_vals.numpy())
    for r in range(q):
        misalign = (r * n) % 4
        if cut == "rows":
            ids, vals, writes = rows_model(counts[r], int(thr[r]), cap, misalign, 64, 2)
        else:
            chunk = 4 * 512 if n > 4 * 512 else 512 + 4 * (r % 3)
            ids, vals, writes = chunks_model(counts[r], int(thr[r]), cap, misalign, 64, 2,
                                             chunk)
        assert (writes == 1).all(), (r, int(thr[r]))
        assert np.array_equal(ids, want_ids[r].numpy()), (r, int(thr[r]))
        assert np.array_equal(vals, want_vals[r].numpy()), (r, int(thr[r]))


@pytest.mark.parametrize("cap", [16, 200, CONST["SMEM_TIES"] + 1])
def test_kernel_constants_rank_model_equals_plain_version(cap):
    """At the kernel's own constants (THREADS, LOADS) over two and a half
    steps a row and a cut of three chunks, for a cap inside and beyond the
    shared tie buffer."""
    threads, loads = CONST["THREADS"], CONST["LOADS"]
    n = 5 * threads * loads * 4 // 2 + 3
    rng = np.random.default_rng(cap)
    counts = _counts(rng, 4, n, 9, 2)
    thr = _thresholds(counts, 9, cap)
    want_ids, want_vals = cpq_compact_plain(torch.from_numpy(counts), torch.from_numpy(thr), cap)
    for r in range(4):
        for model in (lambda: rows_model(counts[r], int(thr[r]), cap, (r * n) % 4, threads, loads),
                      lambda: chunks_model(counts[r], int(thr[r]), cap, (r * n) % 4, threads,
                                           loads, -(-n // 3 // 4) * 4)):
            ids, vals, writes = model()
            assert (writes == 1).all()
            assert np.array_equal(ids, want_ids[r].numpy())
            assert np.array_equal(vals, want_vals[r].numpy())


def test_packed_counts_never_carry_and_the_cut_adapts_to_q():
    """A warp's strict and tie counts of a step share a 32-bit word (16 bits
    each) and so do the block's; the index formula covers a step's groups
    once; the cut takes whole rows at both cells' Q = 1024, and at Q = 1 and
    16 chunks (a multiple of 4 counts), no more than N / MIN_CHUNK."""
    threads, loads = CONST["THREADS"], CONST["LOADS"]
    assert threads * loads * 4 < 1 << 16 and loads * 4 <= 32     # sm / tm: one bit a count
    assert re.search(r"constexpr int WARP_GROUPS = 32 \* LOADS;", SRC)
    order = kernel_order(threads * loads * 4 * 3 + 5, 1, threads, loads)
    assert np.array_equal(order, np.arange(len(order)))
    assert SMEM_TIES == CONST["SMEM_TIES"] and SMEM_TIES * 4 <= 48 * 1024  # no opt-in needed
    for fit in (264, 528, 1056):                                 # 132 SMs x 2, 4, 8 blocks
        for n in (250_000, 281_250, 4_500_000):
            assert plan_model(n, 1024, fit)[1] == 1
            for q in (1, 16):
                chunk, n_chunks = plan_model(n, q, fit)
                assert 1 < n_chunks <= -(-n // MIN_CHUNK) and chunk % 4 == 0
                assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
                assert n_chunks * q <= fit + q
    assert plan_model(4097, 1, 264) == (4100, 1)                 # shorter than a chunk


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    """On the CPU the wrapper is the plain version, whatever the dtype, and
    launches nothing; c-PQ and SPQ call it on their kernel path."""
    rng = np.random.default_rng(5)
    counts = torch.from_numpy(_counts(rng, 5, 1001, 12, 3))
    thr = torch.tensor([-1, 0, 4, 12, 13], dtype=torch.int32)
    common.reset_launch_counts()
    want = cpq_compact_plain(counts, thr, 40)
    for c in (counts, counts.to(torch.int16), counts.to(torch.int64)):
        got = cpq_compact(c, thr, 40)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    from repro_torch.core import spq
    from repro_torch.core.types import SearchParams, TopKMethod

    for method, select in ((TopKMethod.CPQ, cpq.cpq_select), (TopKMethod.SPQ, spq.spq_select)):
        params = SearchParams(k=20, max_count=12, method=method)
        a = select(counts, dataclasses.replace(params, use_kernel=False))
        b = select(counts, params)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.counts, b.counts)
    assert common.launch_counts() == {}
