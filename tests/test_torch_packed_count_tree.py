"""The arithmetic of packed_cosine_count's carry-save tile
(src/repro_torch/kernels/csrc/packed_cosine.cu, namespace `count`), checked
on the CPU.  The CUDA kernel runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py); here a numpy model of its tile -- the LOP3 truth tables it
uses, the carry-save tree over eight xor words, the words taken eight at a
time with every group after the first subtracted from the stored counts, and
its map of threads to output elements -- is held against the port's plain
version and the JAX package's `repro.core.packing.packed_cosine_match` on the
same seeded inputs.  Everything is integer: equality, no tolerance.

The tree: with x_w = q_w ^ d_w, four carry-save adders (sum = xor3, carry =
majority) turn x_0 .. x_6 into ones, twos and fours words beside x_7, and

    sum_w popc(x_w) = popc(ones) + popc(x_7) + 2 popc(twos) + 4 popc(fours)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro_torch.core import packing
from repro_torch.kernels import build
from repro_torch.kernels.packed_cosine import packed_cosine_count_plain

SRC = (build.CSRC_DIR / "packed_cosine.cu").read_text()
COUNT = SRC[SRC.index("namespace count {"):SRC.index("}  // namespace count")]
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", COUNT).group(1))
WARPS = THREADS // 32
RN = int(re.search(r"constexpr int RN = (\d+);", COUNT).group(1))
TN = WARPS * 32 * RN                             # a thread's RN data rows 32 apart
assert "constexpr int TN = WARPS * 32 * RN;" in COUNT
TQ = int(re.search(r"constexpr int TQ = (\d+);", COUNT).group(1))
G = int(re.search(r"constexpr int G = (\d+);", COUNT).group(1))
LUTS = dict(re.findall(r"unsigned (xor3|maj3)\(.*?lop3\.b32 %0, %1, %2, %3, (0x[0-9A-Fa-f]+);",
                       COUNT, re.S))


def _popc(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint32 (SWAR, wrapping uint32 arithmetic)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _lop3(lut: int, a, b, c):
    """PTX lop3.b32: bit i of the result is bit (a_i b_i c_i) of the table,
    a the most significant (0xF0, 0xCC, 0xAA are a, b and c themselves)."""
    out = np.zeros(np.broadcast(a, b, c).shape, dtype=np.uint32)
    for idx in range(8):
        if lut >> idx & 1:
            ma = a if idx & 4 else ~a
            mb = b if idx & 2 else ~b
            mc = c if idx & 1 else ~c
            out |= ma & mb & mc
    return out


def test_lop3_tables_are_xor3_and_majority():
    assert set(LUTS) == {"xor3", "maj3"}
    a, b, c = np.uint32(0xF0), np.uint32(0xCC), np.uint32(0xAA)
    assert int(LUTS["xor3"], 16) == int(a ^ b ^ c)
    assert int(LUTS["maj3"], 16) == int((a & b) | (a & c) | (b & c))
    rng = np.random.default_rng(1)
    x, y, z = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    assert np.array_equal(_lop3(int(LUTS["xor3"], 16), x, y, z), x ^ y ^ z)
    assert np.array_equal(_lop3(int(LUTS["maj3"], 16), x, y, z), (x & y) | (x & z) | (y & z))


def _disagree8(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The kernel's disagree8 over [..., 8] uint32 words (broadcasting)."""
    xor3, maj3 = int(LUTS["xor3"], 16), int(LUTS["maj3"], 16)
    x = [q[..., w] ^ d[..., w] for w in range(G)]
    s1, c1 = _lop3(xor3, x[0], x[1], x[2]), _lop3(maj3, x[0], x[1], x[2])
    s2, c2 = _lop3(xor3, x[3], x[4], x[5]), _lop3(maj3, x[3], x[4], x[5])
    ones, c3 = _lop3(xor3, s1, s2, x[6]), _lop3(maj3, s1, s2, x[6])
    twos, fours = _lop3(xor3, c1, c2, c3), _lop3(maj3, c1, c2, c3)
    return _popc(ones) + _popc(x[7]) + 2 * (_popc(twos) + 2 * _popc(fours))


def _thread_elements(q: int, n: int) -> np.ndarray:
    """Every (query, data) element the kernel's threads store, as q * n + n
    over all blocks, warps, lanes, their RN data rows (n0 + 128 warp + lane
    + 32 j) and the block's query rows; rows past Q and N are not stored."""
    n_qtiles = -(-q // TQ)
    block = np.arange(n_qtiles * -(-n // TN))[:, None, None, None, None]
    warp = np.arange(WARPS)[None, :, None, None, None]
    lane = np.arange(32)[None, None, :, None, None]
    j = np.arange(RN)[None, None, None, :, None]
    i = np.arange(TQ)[None, None, None, None, :]
    rows = block // n_qtiles * TN + 32 * RN * warp + lane + 32 * j
    qrow = block % n_qtiles * TQ + i
    rows, qrow = np.broadcast_arrays(rows, qrow)
    keep = (rows < n) & (qrow < q)
    return (qrow[keep] * n + rows[keep]).astype(np.int64)


def _tile_model(dw: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """The kernel's counts [Q, N]: words eight at a time (0 past W), the first
    group storing 32W - dis and every later one subtracting its dis from the
    count its thread stored."""
    n, w = dw.shape
    q = qw.shape[0]
    elems = _thread_elements(q, n)
    assert np.array_equal(np.bincount(elems, minlength=q * n), np.ones(q * n))
    dpad = np.zeros((n, -(-w // G) * G), np.uint32)
    qpad = np.zeros((q, dpad.shape[1]), np.uint32)
    dpad[:, :w], qpad[:, :w] = dw, qw
    out = None
    for k0 in range(0, w, G):
        dis = _disagree8(qpad[:, None, k0:k0 + G], dpad[None, :, k0:k0 + G])
        out = (32 * w if k0 == 0 else out) - dis
    return out


def _words(rng, rows: int, v: int, kind: str, queries: bool, other=None):
    sgn = np.where(rng.integers(0, 2, (rows, v)) > 0, 1, -1).astype(np.int8)
    if kind == "zeros":
        sgn[:] = -1                               # every sign bit 0
    elif kind == "ones":
        sgn[:] = 1
    elif kind == "complement" and other is not None:
        m = min(rows, other.shape[0])
        sgn[:m] = -other[:m]
    pack = packing.pack_signs_queries if queries else packing.pack_signs_data
    return sgn, pack(torch.from_numpy(sgn))


@pytest.mark.parametrize("w", range(1, 18))
@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "complement"])
def test_tile_model_equals_plain_and_reference(w, kind):
    rng = np.random.default_rng(100 * w + len(kind))
    v = 32 * w - int(rng.integers(0, 32))        # a ragged last word most of the time
    n, q = (1030, 66) if w in (1, 8, 9, 17) else (97, 5)
    dsg, dw = _words(rng, n, v, kind, queries=False)
    _, qw = _words(rng, q, v, kind, queries=True, other=dsg)
    want = packed_cosine_count_plain(dw, qw)
    got = _tile_model(dw.numpy().view(np.uint32), qw.numpy().view(np.uint32))
    assert np.array_equal(got, want.numpy())
    ref = np.asarray(jpacking.packed_cosine_match(jnp.asarray(dw.numpy()), jnp.asarray(qw.numpy())))
    assert np.array_equal(got, ref)
    if kind in ("zeros", "ones"):                # every sign agrees but the tail: V
        assert (got == v).all()
    if kind == "complement":                     # every sign disagrees with its partner
        assert (np.diagonal(got)[:min(n, q)] == 0).all()


def test_tree_identity_on_extreme_words():
    """disagree8 = sum of popcounts for every mix of all-zero, all-one and
    one-bit words, and for random words."""
    rng = np.random.default_rng(5)
    pool = np.array([0, 0xFFFFFFFF, 1, 0x80000000, 0x55555555, 0xAAAAAAAA], dtype=np.uint32)
    q = pool[rng.integers(0, len(pool), (4096, G))]
    d = pool[rng.integers(0, len(pool), (4096, G))]
    q[:1024] = rng.integers(0, 2**32, (1024, G), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(_disagree8(q, d), _popc(q ^ d).sum(axis=-1))
    assert int(_disagree8(np.zeros((1, G), np.uint32), np.full((1, G), 0xFFFFFFFF,
                                                               np.uint32))[0]) == 256
