"""The arithmetic of the fused COSINE top-k kernel's count tile and of the
c-PQ histogram kernel (src/repro_torch/kernels/csrc/fused_topk.cuh,
packed_cosine.cu, cpq_hist.cu), checked on the CPU.  The CUDA kernels run
only on the card (tests/test_torch_gpu.py, chip_smoke.py); here plain models
of what they do are held against the port's plain versions and the JAX
package's reference (`repro.core.match.match_cosine` + `repro.core.cpq`,
`repro.kernels.ref.cpq_hist`) on the same seeded numpy inputs.  Everything is
integer-valued: equality, no tolerance.

The fused kernel stores a count c of a row of W sign words as s = max(c - L,
0), L = max(0, 32W - 254) in a one-byte tile (W <= 9), L = max(0, 32W -
65534) in a two-byte one; the threshold t comes from exact histograms, and an
entry stored as 0 is recounted from the words when t <= L.  The histogram
kernel counts into 16-bit halves of 32-bit words, one column of words a
thread, flushed before a half can carry."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpq as jcpq, match as jmatch
from repro.core.types import SearchParams as JSearchParams
from repro.kernels import ref as jref
from repro_torch.core import packing
from repro_torch.core.plan import _fused_candidates_topk
from repro_torch.kernels import build, common
from repro_torch.kernels.cpq_hist import MAX_BINS, cpq_hist, cpq_hist_plain
from repro_torch.kernels.packed_cosine import TILE_N, packed_cosine_count_plain

COSINE_SRC = (build.CSRC_DIR / "packed_cosine.cu").read_text()
FUSED_SRC = (build.CSRC_DIR / "fused_topk.cuh").read_text()
HIST_SRC = (build.CSRC_DIR / "cpq_hist.cu").read_text()
MAX_W_ONE_BYTE = int(re.search(r"constexpr int MAX_W_ONE_BYTE = (\d+);", COSINE_SRC).group(1))


def _signs(rng, n, v):
    return (rng.integers(0, 2, (n, v)) * 2 - 1).astype(np.int8)


def _rows(rng, q, n, v, kind):
    """Sign rows: "random", or "complement": data rows the complement of
    query 0 with L - 4 + r % 5 signs flipped back (L + 1 in every 97th row,
    a random row in every 37th), so fewer than 100 rows of a tile count above
    L = max(0, 32W - 254); query 1 the complement of data row 3."""
    s = _signs(rng, q, v)
    if kind == "random":
        return _signs(rng, n, v), s
    low = max(0, 32 * (-(-v // 32)) - 254)
    d = np.tile(-s[0], (n, 1))
    r = np.arange(n)
    flips = np.clip(np.where(r % 97 == 1, low + 1, low - 4 + r % 5), 0, v)
    rank = rng.random((n, v)).argsort(axis=1).argsort(axis=1)    # a random order a row
    d = np.where(rank < flips[:, None], -d, d)
    d[::37] = _signs(rng, len(range(0, n, 37)), v)
    s[1] = -d[3]
    return d, s


def fused_topk_model(dw: torch.Tensor, qw: torch.Tensor, k: int, count_bytes: int):
    """The fused kernel's candidate buffers, computed as it computes them:
    the count tile stores max(c - L, 0) (PAST marks no entry here: the model
    cuts the last tile short), the histogram is of the exact counts, t the
    largest count with #{>= t} >= kc (else 0), every entry of count c >= t
    takes slot #{count > c} + its rank among equal counts in id order, an
    entry stored as 0 with L > 0 is recounted from the words only when t <=
    L.  Returns (ids, counts, number of recounted entries)."""
    exact = packed_cosine_count_plain(dw, qw)
    q, n = exact.shape
    w = dw.shape[1]
    nbins = 32 * w + 1
    low = max(0, nbins - 1 - ((1 << (8 * count_bytes)) - 2))
    kc = min(k, TILE_N)
    n_tiles = -(-n // TILE_N)
    ids = torch.full((q, n_tiles * kc), -1, dtype=torch.int32)
    cnts = torch.full_like(ids, -1)
    recounts = 0
    for r in range(q):
        for tile in range(n_tiles):
            n0 = tile * TILE_N
            c = exact[r, n0:n0 + TILE_N]
            stored = torch.where(c > low, c - low, 0)
            hist = torch.bincount(c.long(), minlength=nbins)
            at_least = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
            hit = torch.nonzero(at_least >= kc).flatten()
            t = int(hit.max()) if hit.numel() else 0
            base = torch.cat([at_least[1:], at_least.new_zeros(1)])       # #{count > c}
            dec = stored + low
            if low > 0:
                collapsed = torch.nonzero(stored == 0).flatten()
                if t <= low and collapsed.numel():
                    recounts += collapsed.numel()
                    dec[collapsed] = packed_cosine_count_plain(
                        dw[n0 + collapsed], qw[r:r + 1])[0]
                else:
                    dec[collapsed] = -1
            taken = {}
            for i in torch.nonzero(dec >= t).flatten().tolist():
                cnt = int(dec[i])
                slot = int(base[cnt]) + taken.get(cnt, 0)
                taken[cnt] = taken.get(cnt, 0) + 1
                if slot < kc:
                    ids[r, tile * kc + slot] = n0 + i
                    cnts[r, tile * kc + slot] = cnt
    return ids, cnts, recounts


@pytest.mark.parametrize("k", [1, 100, 2500])
@pytest.mark.parametrize("kind", ["random", "complement"])
@pytest.mark.parametrize("w", [1, 7, 8, 9, 17])
def test_fused_count_tile_model_equals_plain_version_and_reference(w, kind, k):
    """The kernel's count tile as the wrapper picks it (one byte, low end
    collapsed, while W <= MAX_W_ONE_BYTE; two bytes above): buffers equal to
    local_topk_plain, merged result equal to the JAX reference's sort of
    match_cosine; on complement rows of W = 8 and 9 the recount runs."""
    rng = np.random.default_rng(100 * w + k + len(kind))
    q, n, v = 3, 4500, 32 * w - (w > 1) * 18          # V = 238 at W = 8
    d, s = _rows(rng, q, n, v, kind)
    dw, qw = packing.pack_signs_data(torch.from_numpy(d)), packing.pack_signs_queries(
        torch.from_numpy(s))
    count_bytes = 1 if w <= MAX_W_ONE_BYTE else 2
    ids, cnts, recounts = fused_topk_model(dw, qw, k, count_bytes)
    pids, pcnts = common.local_topk_plain(packed_cosine_count_plain(dw, qw), k, TILE_N)
    assert torch.equal(ids, pids) and torch.equal(cnts, pcnts)
    if kind == "complement" and count_bytes == 1 and w >= 8 and k > 1:
        assert recounts > 0                            # t <= L in query 0's tiles
    if count_bytes == 1 and w <= 7:
        assert recounts == 0                           # nothing collapses below W = 8
    got = _fused_candidates_topk(lambda *_: (ids, cnts), None, None, k)
    oracle = jcpq.sort_select(jmatch.match_cosine(jnp.asarray(d), jnp.asarray(s)),
                              JSearchParams(k=min(k, n), max_count=v))
    kk = min(k, n)
    assert np.array_equal(got[0][:, :kk].numpy(), np.asarray(oracle.ids))
    assert np.array_equal(got[1][:, :kk].numpy(), np.asarray(oracle.counts))


@pytest.mark.parametrize("kind", ["random", "complement"])
@pytest.mark.parametrize("w", [1, 7, 8, 9, 17])
def test_two_byte_count_tile_model_equals_plain_version(w, kind):
    """The other form measured at W = 8: a two-byte tile, in which no count
    collapses below W = 2048."""
    rng = np.random.default_rng(7 * w + len(kind))
    q, n, v = 3, 4500, 32 * w
    d, s = _rows(rng, q, n, v, kind)
    dw, qw = packing.pack_signs_data(torch.from_numpy(d)), packing.pack_signs_queries(
        torch.from_numpy(s))
    ids, cnts, recounts = fused_topk_model(dw, qw, 100, count_bytes=2)
    pids, pcnts = common.local_topk_plain(packed_cosine_count_plain(dw, qw), 100, TILE_N)
    assert recounts == 0
    assert torch.equal(ids, pids) and torch.equal(cnts, pcnts)


def test_cosine_tile_forms_and_bins_thresholds_are_what_the_source_says():
    """One byte a count for 64 query rows while W <= 9, whose 32W + 1 bins a
    row then fit beside the tile; two bytes for 32 rows above, bins in shared
    memory up to W = 15; L = 32W - 254 from W = 8 on the one-byte tile."""
    const = {k: int(v) for k, v in re.findall(r"constexpr int (K_\w+|MAX_SMEM) = (\d+);",
                                              FUSED_SRC)}
    shapes = dict(re.findall(r"using (CosU\d+) = Fused<(uint\d+_t, \d+, \d+)>;", COSINE_SRC))
    assert shapes == {"CosU8": "uint8_t, 64, 16", "CosU16": "uint16_t, 32, 16"}
    threads, rq, rn, tn = const["K_THREADS"], const["K_RQ"], const["K_RN"], const["K_TN"]

    def fits(count_bytes, tq, kw, w):
        sn = threads // (tq // rq) * rn
        fixed = tq * tn * count_bytes + (sn * (kw + 1) + tq * kw) * 4
        return fixed + tq * (32 * w + 1) * 4 <= const["MAX_SMEM"]

    assert MAX_W_ONE_BYTE == 9 and fits(1, 64, 16, 9) and not fits(1, 64, 16, 10)
    assert fits(2, 32, 16, 15) and not fits(2, 32, 16, 16)
    assert "up to\n// w = 15" in COSINE_SRC and "above w = 15" in COSINE_SRC
    lows = {w: max(0, 32 * w - 254) for w in (7, 8, 9)}
    assert lows == {7: 0, 8: 2, 9: 34}


# ---------------------------------------------------------------------------
# cpq_hist: 16-bit halves, one column a thread
# ---------------------------------------------------------------------------

def _hist_constants():
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", HIST_SRC)}
    assert re.search(r"constexpr int FLUSH_STEPS = 65535 / \(4 \* LOADS\);", HIST_SRC)
    const["FLUSH_STEPS"] = 65535 // (4 * const["LOADS"])
    return const


def private_counter_hist(row: np.ndarray, nbins: int, misalign: int, threads: int,
                         loads: int, flush_steps: int):
    """The kernel's counting of one block's range `row` (its first element
    `misalign` elements past a 16-byte boundary): elements before the
    boundary go to threads 0.., then 4-element groups g to thread g %
    threads (step g // (threads * loads)), then the tail to threads 0..; each
    thread adds 1 (even bin) or 1 << 16 (odd bin) to word bin // 2 of its
    column -- a count outside [0, nbins) to the dummy bin nbins --, and the
    columns are summed and zeroed every `flush_steps` steps.  Returns (hist,
    the largest half any thread held for a real bin before a flush)."""
    n = len(row)
    head = min(n, (4 - misalign) % 4)
    groups = (n - head) // 4
    thread = np.empty(n, dtype=np.int64)
    span = np.zeros(n, dtype=np.int64)
    thread[:head] = np.arange(head)
    g = np.arange(groups * 4) // 4
    thread[head:head + 4 * groups] = g % threads
    span[head:head + 4 * groups] = g // (threads * loads) // flush_steps
    tail = n - head - 4 * groups
    thread[n - tail:] = np.arange(tail)
    span[n - tail:] = span[head + 4 * groups - 1] if groups else 0
    b = np.minimum(row.astype(np.int64) & 0xFFFFFFFF, nbins)    # min((unsigned)v, nbins)
    n_words = nbins // 2 + 1
    at = (span * n_words + b // 2) * threads + thread
    words = np.bincount(at, weights=np.where(b % 2 == 1, 1 << 16, 1),
                        minlength=(span.max() + 1) * n_words * threads).astype(np.int64)
    halves = np.stack([words & 0xFFFF, words >> 16], axis=-1)      # [.., lo / hi]
    bins = halves.reshape(-1, n_words, threads, 2).transpose(0, 1, 3, 2).reshape(
        -1, 2 * n_words, threads)[:, :nbins]                       # [span, bin, thread]
    return bins.sum(axis=(0, 2)), int(bins.max(initial=0))


@pytest.mark.parametrize("nbins", [1, 2, 15, 128, 239, 453])
@pytest.mark.parametrize("misalign", [0, 1, 2, 3])
def test_private_counter_model_equals_plain_version_and_reference(nbins, misalign):
    """Skewed rows with -1 and past-the-end entries, odd lengths, flushed
    every step and every three steps: the halves add up to the histogram of
    the plain version and of the reference."""
    rng = np.random.default_rng(nbins * 4 + misalign)
    q, n = 3, 20001 + misalign
    counts = rng.integers(-1, nbins + 3, size=(q, n)).astype(np.int32)
    counts[:, ::3] = nbins // 2
    want = cpq_hist_plain(torch.from_numpy(counts), nbins - 1).numpy()
    assert np.array_equal(want, np.asarray(jref.cpq_hist(jnp.asarray(counts), nbins)))
    assert torch.equal(cpq_hist(torch.from_numpy(counts), nbins - 1), torch.from_numpy(want))
    for flush_steps in (1, 3):
        for r in range(q):
            got, _ = private_counter_hist(counts[r], nbins, misalign, threads=64, loads=2,
                                          flush_steps=flush_steps)
            assert np.array_equal(got, want[r])


def test_private_counter_halves_never_carry():
    """At the kernel's constants every element of a range in one bin (the
    worst skew) leaves each half below 2**16 before its flush, and the
    counters and the dummy bin fit beside each other up to 453 bins; wider
    histograms (up to
    the wrapper's MAX_BINS) take one int32 copy a block."""
    const = _hist_constants()
    threads, loads, steps = const["THREADS"], const["LOADS"], const["FLUSH_STEPS"]
    assert steps * 4 * loads + 2 <= 0xFFFF
    for misalign in range(4):
        n = steps * threads * loads * 4 + 7 + misalign       # one flush, then a ragged rest
        row = np.zeros(n, dtype=np.int32)
        for b in (0, 1):
            got, largest = private_counter_hist(row + b, 2, misalign, threads, loads, steps)
            assert largest <= 0xFFFF and largest >= steps * 4 * loads
            assert got.tolist() == ([n, 0] if b == 0 else [0, n])
    def counter_bytes(nbins):
        return (nbins // 2 + 1) * threads * 4                   # bins 0 .. nbins

    assert counter_bytes(453) <= const["MAX_SMEM"] < counter_bytes(454)
    assert MAX_BINS * 4 == const["MAX_SMEM"] and "nbins <= 453" in HIST_SRC


def _lanes(bits):
    """The kernel's SWAR lane tests (Lanes<T> in fused_topk.cuh) for lanes of
    `bits` bits, in numpy uint64 arithmetic cut to 32 bits."""
    h = np.uint64(0x80808080 if bits == 8 else 0x80008000)
    low = np.uint64(0x7F7F7F7F if bits == 8 else 0x7FFF7FFF)        # ~h in 32 bits

    def eq(x, y):
        z = x ^ y
        return ~((z & low) + low | z) & h

    def ge(x, y):
        d = (x | h) - (y & low)                 # each lane >= 1: no borrow between lanes
        return ((x & ~y) | (~(x ^ y) & d)) & h

    return eq, ge


@pytest.mark.parametrize("bits", [8, 16])
def test_lane_tests_of_the_count_tile_are_exact(bits):
    """eq and ge set exactly the top bit of each lane where the lane of x
    equals / is at least the lane of y: every pair of byte values in every
    lane of a word (the other lanes random), and 2**16 pairs of 16-bit
    values, ends of the range included."""
    eq, ge = _lanes(bits)
    rng = np.random.default_rng(bits)
    per, mask = 32 // bits, (1 << bits) - 1
    if bits == 8:
        a, b = np.meshgrid(np.arange(256), np.arange(256))
    else:
        a = np.concatenate([rng.integers(0, 1 << 16, 60000), [0, 0, mask, mask, 1, 0x8000]])
        b = np.concatenate([rng.integers(0, 1 << 16, 60000), [0, mask, 0, mask, 0x7FFF, 0x8000]])
        b[:3000] = a[:3000]                                 # equal pairs
    a, b = a.ravel().astype(np.uint64), b.ravel().astype(np.uint64)
    for lane in range(per):
        rest_x = rng.integers(0, 1 << 32, a.size).astype(np.uint64)
        rest_y = rng.integers(0, 1 << 32, a.size).astype(np.uint64)
        keep = np.uint64(~(mask << (bits * lane)) & 0xFFFFFFFF)
        x = (rest_x & keep) | (a << np.uint64(bits * lane))
        y = (rest_y & keep) | (b << np.uint64(bits * lane))
        top = np.uint64(1 << (bits * lane + bits - 1))
        assert np.array_equal((eq(x, y) & top) != 0, a == b)
        assert np.array_equal((ge(x, y) & top) != 0, a >= b)
