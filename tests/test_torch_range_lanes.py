"""The arithmetic of the float16 tiles behind range_count and
packed_tanimoto_count (src/repro_torch/kernels/csrc/range_count.cu and the
count kernel of packed_tanimoto.cu), checked on the CPU.  The CUDA kernels
run only on the card (tests/test_torch_gpu.py, chip_smoke.py); here plain
PyTorch models of their two paths, with float16 arithmetic where the kernels
use it, are held against the port's plain versions and the JAX package's
references (`repro.core.match.match_range`, `match_tanimoto`,
`repro.core.packing.packed_tanimoto_match`) on the same seeded numpy inputs.
Everything is integer-valued: equality, no tolerance.

RANGE: a chunk of 16 attributes of a 128-row data tile whose values all lie
in [-2048, 2048] is tested in float16 as sat(x + 1 - lo') * sat(hi' + 1 - x)
with lo', hi' bounds in [-2049, 2049] that test alike on those values and make
1 - lo', hi' + 1 exact float16 integers, two attributes a word; any other
chunk as int32.  Each chunk's counts (at most 16) go into the output, added
after the first.
Packed TANIMOTO: each byte widens to the float16 whose pattern it is and a
chunk of 32 columns is counted by float16 compares, each adding 2^-24 into
the lane of its column's parity.  Both keep a lane's count k <= 2047 as the float16 k * 2^-24,
whose bit pattern is k."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import match as jmatch
from repro.core import packing as jpacking
from repro_torch.core import packing
from repro_torch.kernels import build
from repro_torch.kernels.packed_tanimoto import packed_tanimoto_count_plain
from repro_torch.kernels.range_count import range_count_plain

RANGE_SRC = (build.CSRC_DIR / "range_count.cu").read_text()
PTAN_SRC = (build.CSRC_DIR / "packed_tanimoto.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


KD = _const(RANGE_SRC, "KD")                     # attributes a chunk
TN = 128                                         # data rows a tile (32 threads x 4)
LANE_MAX, CLAMP = 2048, 2049
KH = _const(PTAN_SRC, "KH")                      # float16 words a chunk (2 columns each)
KS = 2 * KH                                      # columns a chunk
FLUSH_CHUNKS = 2047 // KH
EPS = 2.0 ** -24
I32 = np.iinfo(np.int32)

# the pools of chip_smoke.py's range_operands
LANE_POOL = [-2048, -2047, -1, 0, 1, 1023, 1024, 2047, 2048]
GENERAL_POOL = [int(I32.min), int(I32.min) + 1, -2050, -2049, 2049, 2050, int(I32.max) - 1,
                int(I32.max)]
BOUND_POOL = [int(I32.min), -2051, -2050, -2049, -2048, -2047, -1, 0, 1, 2047, 2048, 2049,
              2050, 2051, int(I32.max)]


def test_the_tile_constants_are_the_sources():
    assert (KD, KH, KS) == (16, 16, 32)
    assert f"constexpr int CLAMP = {CLAMP};" in RANGE_SRC
    assert "constexpr int FLUSH_CHUNKS = 2047 / KH;" in PTAN_SRC
    assert FLUSH_CHUNKS == 127 and FLUSH_CHUNKS * KH <= 2047   # a lane gains KH a chunk


def _half_bits(k: torch.Tensor) -> torch.Tensor:
    """int counts as the float16 k * 2^-24, read back as their bit patterns."""
    return (k.to(torch.float16) * EPS).view(torch.int16).to(torch.int32)


def test_lane_bits_equal_the_count_up_to_2048():
    """The subnormals and the first binade of float16 are 2^-24 apart, so the
    bits of k * 2^-24 are k up to 2048; above it the step is 2^-23 (2050 has
    the bits 2049).  The kernels flush a lane before it passes 2047."""
    k = torch.arange(2049, dtype=torch.int32)
    assert torch.equal(_half_bits(k), k)
    assert int(_half_bits(torch.tensor([2050]))) == 2049


def lo_bound(lo: torch.Tensor) -> torch.Tensor:
    """range_count.cu's lo': -2049 where lo <= -2048, else min(lo, 2049)."""
    return torch.where(lo <= -LANE_MAX, -CLAMP, lo.clamp(max=CLAMP))


def hi_bound(hi: torch.Tensor) -> torch.Tensor:
    """range_count.cu's hi': 2049 where hi >= 2048, else max(hi, -2049)."""
    return torch.where(hi >= LANE_MAX, CLAMP, hi.clamp(min=-CLAMP))


def test_saturated_tests_are_exact_for_every_value_and_bound():
    """With lo', hi' as the kernel moves them, 1 - lo' and hi' + 1 are exact
    float16 integers and sat(x + (1 - lo')) == [x >= lo], sat((hi' + 1) - x)
    == [x <= hi] in float16, for every x in [-2048, 2048] and every bound in
    [-2051, 2051] and at the ends of int32.  Without the move, lo = -2048
    would need the offset 2049, which float16 rounds to 2048."""
    x = torch.arange(-LANE_MAX, LANE_MAX + 1, dtype=torch.int32)
    b = torch.cat([torch.arange(-CLAMP - 2, CLAMP + 3, dtype=torch.int32),
                   torch.tensor([int(I32.min), -70000, 70000, int(I32.max)], dtype=torch.int32)])
    c_lo, c_hi = 1 - lo_bound(b), hi_bound(b) + 1
    for c in (c_lo, c_hi):
        assert torch.equal(c.to(torch.float16).to(torch.int32), c)
        assert set(c.tolist()) <= set(range(-LANE_MAX, LANE_MAX + 1)) | {2050}
    xh = x.to(torch.float16)
    ge = (xh[None, :] + c_lo.to(torch.float16)[:, None]).clamp(0, 1)
    le = (c_hi.to(torch.float16)[:, None] - xh[None, :]).clamp(0, 1)
    assert torch.equal(ge, (x[None, :] >= b[:, None]).to(torch.float16))
    assert torch.equal(le, (x[None, :] <= b[:, None]).to(torch.float16))
    assert float(torch.tensor(2049.0).to(torch.float16)) == 2048.0


def range_tile_model(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """A plain model of range_count.cu: data tiles of TN rows, chunks of KD
    attributes, the last one padded to KD with data 0 against the interval
    (1, 0); a chunk whose values all lie in [-2048, 2048] is tested in
    float16 against the moved bounds (sat(x + c_lo) * sat(c_hi - x) added
    into the float16 lane of the attribute's parity), any other as int32
    (1.0 added there where lo <= x <= hi); a chunk's count is the sum of the
    bits of its two lanes times 2^-24, written by the first chunk and added
    by the others."""
    n, d = x.shape
    q = lo.shape[0]
    chunks = max(1, -(-d // KD))
    pad = chunks * KD - d
    x = torch.cat([x, x.new_zeros((n, pad))], 1)
    lo = torch.cat([lo, lo.new_ones((q, pad))], 1)
    hi = torch.cat([hi, hi.new_zeros((q, pad))], 1)
    c_lo = (1 - lo_bound(lo)).to(torch.float16)
    c_hi = (hi_bound(hi) + 1).to(torch.float16)
    out = torch.zeros((q, n), dtype=torch.int32)
    for t0 in range(0, n, TN):
        xt = x[t0:t0 + TN]
        for c in range(chunks):
            cols = range(c * KD, (c + 1) * KD)
            lanes = torch.zeros((2, q, xt.shape[0]), dtype=torch.float16)
            chunk = xt[:, cols[0]:cols[-1] + 1]
            fast = bool(((chunk >= -LANE_MAX) & (chunk <= LANE_MAX)).all())
            for a in cols:
                if fast:
                    xh = xt[:, a].to(torch.float16)[None, :]
                    ge = (xh + c_lo[:, a:a + 1]).clamp(0, 1)
                    le = (c_hi[:, a:a + 1] - xh).clamp(0, 1)
                    lanes[a % 2] = lanes[a % 2] + ge * le
                else:
                    hit = (lo[:, a:a + 1] <= xt[None, :, a]) & (xt[None, :, a] <= hi[:, a:a + 1])
                    lanes[a % 2] = lanes[a % 2] + hit.to(torch.float16)
            assert float(lanes.float().max()) <= KD // 2
            bits = (lanes * EPS).view(torch.int16).to(torch.int32).sum(0)
            out[:, t0:t0 + TN] = (out[:, t0:t0 + TN] if c else 0) + bits
    return out


def range_operands(rng: np.random.Generator, q: int, n: int, d: int, kind: str):
    """numpy int32 (x [n, d], lo, hi [q, d]) of the kinds of chip_smoke.py's
    range_operands: "lanes" data in [-2048, 2048], "mixed" with one value of
    GENERAL_POOL in one row of every third 128-row tile from the second on,
    "int32" anywhere; intervals around data values, bounds from BOUND_POOL,
    lo == hi, and rows 0 to 2 all, none and the pad (1, 0)."""
    if kind == "int32":
        x = rng.integers(I32.min, I32.max, (n, d), endpoint=True)
        share, pool = 0.5, LANE_POOL + GENERAL_POOL
    else:
        x = rng.integers(-LANE_MAX, LANE_MAX, (n, d), endpoint=True)
        share, pool = 1 / 3, LANE_POOL
    x = np.where(rng.random((n, d)) < share, rng.choice(pool, (n, d)), x)
    if kind == "mixed":
        for t in range(1, -(-n // TN), 3):
            x[TN * t + rng.integers(0, min(TN, n - TN * t)), t % d] = \
                GENERAL_POOL[t % len(GENERAL_POOL)]
    centre = x[rng.integers(0, n, q)]
    lo = centre - rng.integers(0, 31, (q, d))
    hi = centre + rng.integers(0, 31, (q, d))
    for b in (lo, hi):
        swap = rng.random((q, d)) < 1 / 3
        b[swap] = rng.choice(BOUND_POOL, int(swap.sum()))
    hi[:, ::3] = lo[:, ::3]
    for row, (a, b) in enumerate(((I32.min, I32.max), (I32.max, I32.min), (1, 0))[:q]):
        lo[row], hi[row] = a, b
    return tuple(np.clip(t, I32.min, I32.max).astype(np.int32) for t in (x, lo, hi))


def _range_references(x, lo, hi):
    want = np.asarray(jmatch.match_range(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi)))
    plain = range_count_plain(*(torch.from_numpy(t) for t in (x, lo, hi)))
    assert np.array_equal(plain.numpy(), want)
    return want


# d = 1 to 37 across one, two and three chunks; N past one tile, odd
RANGE_CASES = [(1, 5, 1), (3, 130, 2), (4, 61, 3), (5, 257, 7), (6, 300, 13), (7, 200, 14),
               (5, 131, 15), (9, 259, 16), (4, 130, 17), (3, 129, 31), (6, 385, 33),
               (5, 257, 37)]


@pytest.mark.parametrize("kind", ["lanes", "mixed", "int32"])
@pytest.mark.parametrize("q,n,d", RANGE_CASES, ids=lambda v: str(v))
def test_range_tile_model_equals_the_references(q, n, d, kind):
    x, lo, hi = range_operands(np.random.default_rng(q * 1000 + n + d), q, n, d, kind)
    want = _range_references(x, lo, hi)
    got = range_tile_model(*(torch.from_numpy(t) for t in (x, lo, hi)))
    assert np.array_equal(got.numpy(), want)
    if q >= 3:
        assert (want[0] == d).all() and (want[1] == 0).all() and (want[2] == 0).all()


@pytest.mark.parametrize("value", [-2049, -2048, 2048, 2049])
def test_one_value_past_2048_moves_its_chunk_to_the_int32_path(value):
    """A chunk of values in [-2048, 2048] stays on the float16 path with -2048
    or 2048 in it and leaves it with -2049 or 2049; both count exactly,
    against bounds on either side of the value and of the clamp."""
    rng = np.random.default_rng(abs(value))
    n, d = 140, 20
    x = rng.integers(-LANE_MAX, LANE_MAX, (n, d), endpoint=True).astype(np.int32)
    x[3, 5] = x[130, 17] = value
    bounds = np.array([value - 1, value, value + 1, -CLAMP, CLAMP, -CLAMP - 1, CLAMP + 1])
    lo = np.stack([np.full(d, b) for b in bounds] + [np.full(d, I32.min)]).astype(np.int32)
    hi = np.stack([np.full(d, b) for b in bounds] + [np.full(d, I32.max)]).astype(np.int32)
    lo, hi = np.concatenate([lo, lo]), np.concatenate([hi, np.full_like(hi, I32.max)])
    chunk = torch.from_numpy(x[:TN, :KD])
    assert bool(((chunk >= -LANE_MAX) & (chunk <= LANE_MAX)).all()) == (abs(value) <= LANE_MAX)
    want = _range_references(x, lo, hi)
    assert want[:, 3].sum() > 0                       # the value is counted somewhere
    assert np.array_equal(range_tile_model(*map(torch.from_numpy, (x, lo, hi))).numpy(), want)


def test_range_tile_model_adds_chunk_after_chunk_past_2047_attributes():
    """d = 2100: 132 chunks of 16 attributes, each added into the output; a
    query equal to a data row counts d, more than a float16 lane holds."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1024, (5, 2100)).astype(np.int32)
    lo = np.concatenate([x[1:2], x[:1] - 3, np.full((1, 2100), 1)]).astype(np.int32)
    hi = np.concatenate([x[1:2], x[:1] + 3, np.full((1, 2100), 0)]).astype(np.int32)
    want = _range_references(x, lo, hi)
    assert want[0, 1] == want[1, 0] == 2100 and (want[2] == 0).all()
    assert np.array_equal(range_tile_model(*map(torch.from_numpy, (x, lo, hi))).numpy(), want)


# ---------------------------------------------------------------------------
# packed TANIMOTO: bytes widened to float16 lanes, and the SWAR share
# ---------------------------------------------------------------------------

PAD_DATA, PAD_QUERY = 255, 254


def test_byte_patterns_are_distinct_finite_halves_and_the_pads_equal_nothing_else():
    b = torch.arange(256, dtype=torch.int16)
    h = b.view(torch.float16)
    assert bool(torch.isfinite(h).all()) and int(torch.unique(h.float()).numel()) == 256
    assert (h.float() == 0).nonzero().flatten().tolist() == [0]
    eq = h[:, None] == h[None, :]
    assert torch.equal(eq, torch.eye(256, dtype=torch.bool))
    assert not bool(h[PAD_DATA] == h[PAD_QUERY])


def _popc4(z: torch.Tensor) -> torch.Tensor:
    return sum((z >> s) & 1 for s in (7, 15, 23, 31))


def eq_lanes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """packed_tanimoto.cu's eq_lanes (the pair count of packed_tanimoto_topk)
    on words held in int64: the zero bytes of a ^ b by the carry-free test,
    counted."""
    x = a ^ b
    y = ((x & 0x7F7F7F7F) + 0x7F7F7F7F) & 0xFFFFFFFF
    return _popc4(~(y | x) & 0x80808080)


def test_eq_lanes_counts_equal_bytes_in_every_lane():
    v = torch.arange(256, dtype=torch.int64)
    a, b = v.repeat_interleave(256), v.repeat(256)
    rng = torch.Generator().manual_seed(1)
    for lane in range(4):
        other_a = torch.randint(0, 256, (a.numel(),), generator=rng)
        other_b = torch.where(torch.rand(a.numel(), generator=rng) < 0.5, other_a,
                              torch.randint(0, 256, (a.numel(),), generator=rng))
        wa = (a << (8 * lane)) | (other_a << (8 * ((lane + 1) % 4)))
        wb = (b << (8 * lane)) | (other_b << (8 * ((lane + 1) % 4)))
        want = (a == b).long() + (other_a == other_b).long() + 2   # two zero lanes besides
        assert torch.equal(eq_lanes(wa, wb), want)


def packed_tile_model(du: torch.Tensor, qu: torch.Tensor) -> torch.Tensor:
    """A plain model of packed_tanimoto.cu's count kernel: rows padded to
    chunks of KS columns (data 255, queries 254), widened to float16 lanes;
    each column's compare adds 2^-24 (an HFMA2 of HSET2's 1.0) into the lane
    of its parity; every FLUSH_CHUNKS chunks and at the end the two lanes'
    bits are added into int32."""
    n, m = du.shape
    q = qu.shape[0]
    chunks = -(-m // KS)
    dp = torch.full((n, chunks * KS), PAD_DATA, dtype=torch.uint8)
    qp = torch.full((q, chunks * KS), PAD_QUERY, dtype=torch.uint8)
    dp[:, :m], qp[:, :m] = du, qu
    out = torch.zeros((q, n), dtype=torch.int32)
    lanes = torch.zeros((2, q, n), dtype=torch.float16)
    for c in range(chunks):
        dh = dp[:, c * KS:(c + 1) * KS].to(torch.int16).view(torch.float16)
        qh = qp[:, c * KS:(c + 1) * KS].to(torch.int16).view(torch.float16)
        for col in range(KS):
            hit = (qh[:, col][:, None] == dh[:, col][None, :]).to(torch.float16)
            lanes[col % 2] = hit * EPS + lanes[col % 2]
        if (c + 1) % FLUSH_CHUNKS == 0 or c == chunks - 1:
            bits = lanes.view(torch.int16).to(torch.int32)
            assert int(bits.max()) <= 2047
            out += bits[0] + bits[1]
            lanes.zero_()
    return out


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 31, 32, 33, 47, 48, 49, 95, 96, 97, 238, 254,
                               255, 300, 4064, 4065, 4096])
def test_packed_tile_model_equals_the_references(m):
    rng = np.random.default_rng(m)
    n, q = (9, 3) if m > 1000 else (37, 6)
    d = rng.integers(0, 254, (n, m)).astype(np.int32)
    s = rng.integers(0, 254, (q, m)).astype(np.int32)
    d[:, 0], s[-1, 0] = 253, 253                         # the domain's ends
    s[0] = d[1]                                          # one row equal in every column
    s[1, ::2] = d[2, ::2]
    want = np.asarray(jmatch.match_tanimoto(jnp.asarray(d), jnp.asarray(s)))
    du, su = (np.array(jpacking.pack_buckets(jnp.asarray(t))) for t in (d, s))
    assert np.array_equal(np.asarray(jpacking.packed_tanimoto_match(jnp.asarray(du),
                                                                     jnp.asarray(su))), want)
    tdu, tsu = torch.from_numpy(du), torch.from_numpy(su)
    assert torch.equal(tdu, packing.pack_buckets(torch.from_numpy(d)))
    assert np.array_equal(packed_tanimoto_count_plain(tdu, tsu).numpy(), want)
    assert np.array_equal(packed_tile_model(tdu, tsu).numpy(), want)
    assert want[0, 1] == m
