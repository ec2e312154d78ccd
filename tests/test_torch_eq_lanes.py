"""The arithmetic of the equality tile behind match_count and tanimoto_count
(`count_eq_tile` in src/repro_torch/kernels/csrc/eq_tile.cuh), checked on the
CPU.  The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py); here a plain PyTorch model of its two float16 lanes is held
against the port's plain version and the JAX package's reference,
`repro.core.match.match_eq`, on the same seeded numpy inputs.  Everything is
integer-valued: equality, no tolerance.

The premise of the tile's fast path: the int16 bit patterns [0, 0x7C00) are
31,744 distinct finite float16 values and 0 is the only zero among them, so
two ids in that range are equal exactly when their float16 patterns compare
equal.  Its flush interval: float16 holds every integer up to 2048 and not
2049, and a lane counts at most half the columns, so 4096 columns fit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import match as jmatch
from repro_torch.kernels.match_count import match_count, match_count_plain
from repro_torch.kernels.tanimoto_count import tanimoto_count, tanimoto_count_plain

LANE_END = 0x7C00          # ids below it take the float16 path
KS = 32                    # columns staged per step
FLUSH = 4096               # columns between two additions of the lanes into int32
PAD = 0x7E00               # the pattern of the columns past m: a quiet NaN


def _halves(ids: torch.Tensor) -> torch.Tensor:
    """int ids in [0, LANE_END) as the float16 values of their bit patterns."""
    return ids.to(torch.int16).view(torch.float16)


def two_lane_count(data: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """A plain model of count_eq_tile: chunks of KS columns; a chunk whose ids
    all lie in [0, LANE_END) compares pairs of columns as float16 halves (the
    odd tail lane is PAD on both sides), any other chunk compares int32; each
    comparison adds 1.0 to the float16 lane of its column's parity, and the
    lanes are added into int32 every FLUSH columns and at the end."""
    n, m = data.shape
    q = query.shape[0]
    out = torch.zeros((q, n), dtype=torch.int32)
    lanes = torch.zeros((q, n, 2), dtype=torch.float16)
    for s0 in range(0, m, KS):
        d, s = data[:, s0:s0 + KS], query[:, s0:s0 + KS]
        fast = bool(((d >= 0) & (d < LANE_END)).all() and ((s >= 0) & (s < LANE_END)).all())
        if fast and d.shape[1] % 2:
            d = torch.cat([d, d.new_full((n, 1), PAD)], 1)
            s = torch.cat([s, s.new_full((q, 1), PAD)], 1)
        for k in range(d.shape[1]):
            if fast:
                hit = _halves(s[:, k])[:, None] == _halves(d[:, k])[None, :]
            else:
                hit = s[:, k][:, None] == d[:, k][None, :]
            lanes[:, :, k % 2] += hit.to(torch.float16)
        if (s0 + KS) % FLUSH == 0 and s0 + KS < m:
            out += lanes.float().sum(-1).to(torch.int32)
            lanes.zero_()
    return out + lanes.float().sum(-1).to(torch.int32)


def test_lane_patterns_are_distinct_finite_halves_and_zero_is_the_only_zero():
    halves = _halves(torch.arange(LANE_END, dtype=torch.int32))
    values = halves.float()                          # exact: float32 holds every float16
    assert bool(torch.isfinite(values).all())
    assert int(torch.unique(values).numel()) == LANE_END == 31744
    assert bool((values[1:] > values[:-1]).all())    # increasing with the pattern
    assert (values == 0).nonzero().flatten().tolist() == [0]
    # every pattern equals itself and no other, as float16 compares them
    assert bool((halves == halves).all())
    assert int((halves[:, None] == halves[None, ::97]).sum()) == halves[::97].numel()
    # the borders: 0x7C00 is +inf (excluded), PAD is a NaN that equals nothing
    border = _halves(torch.tensor([LANE_END, PAD]))
    assert bool(torch.isinf(border[0])) and bool(torch.isnan(border[1]))
    assert not bool(border[1] == border[1])


def test_float16_holds_integers_up_to_2048_and_not_2049():
    ints = torch.arange(2049, dtype=torch.float32)
    assert torch.equal(ints.to(torch.float16).float(), ints)
    assert float(torch.tensor(2049.0).to(torch.float16)) == 2048.0
    # counting by adds of 1.0, as the lanes do: exact to 2048, then stuck
    lane = torch.zeros((), dtype=torch.float16)
    one = torch.ones((), dtype=torch.float16)
    for _ in range(2048):
        lane = lane + one
    assert float(lane) == 2048.0 and float(lane + one) == 2048.0
    # a lane counts at most half the columns between two flushes
    assert -(-FLUSH // 2) == 2048


# straddling the fast path's end: 31743 is the last id it takes
STRADDLE = [0, 1, 1023, 1024, 31742, 31743, 31744, 31745, -1, -2**31, 2**31 - 1]


def _ids(rng, rows, m, kind):
    if kind == "lanes":
        pool = np.array([0, 1, 1023, 1024, 2048, 2049, 8191, 31742, 31743])
    elif kind == "straddle":
        pool = np.array(STRADDLE)
    else:                                              # full int32
        pool = np.concatenate([[-2**31, -1, 0, 31744, 2**31 - 1],
                               rng.integers(-2**31, 2**31 - 1, size=6)])
    return pool[rng.integers(0, len(pool), size=(rows, m))].astype(np.int32)


@pytest.mark.parametrize("m", [1, 2, 31, 33, 237, 238, 4095, 4096, 4097])
@pytest.mark.parametrize("kind", ["lanes", "straddle", "int32"])
def test_two_lane_model_equals_plain_version_and_reference(m, kind):
    rng = np.random.default_rng(17 + m)
    q, n = 3, 7
    data, query = _ids(rng, n, m, kind), _ids(rng, q, m, kind)
    query[0] = data[1]                                 # one row equal in every column
    if kind == "lanes" and m > KS:                     # one chunk on the general path
        data[2, KS] = LANE_END
    want = np.asarray(jmatch.match_eq(jnp.asarray(data), jnp.asarray(query)))
    d, s = torch.from_numpy(data), torch.from_numpy(query)
    got = two_lane_count(d, s)
    assert got.dtype == torch.int32 and got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(match_count_plain(d, s), got)
    assert torch.equal(tanimoto_count_plain(d, s), got)
    assert int(got[0, 1]) == m


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    d = torch.from_numpy(_ids(rng, 9, 40, "straddle"))
    s = torch.from_numpy(_ids(rng, 4, 40, "straddle"))
    for kernel, plain in ((match_count, match_count_plain),
                          (tanimoto_count, tanimoto_count_plain)):
        assert torch.equal(kernel(d, s), plain(d, s))
        assert torch.equal(kernel(d, s), two_lane_count(d, s))
