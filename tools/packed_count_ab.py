#!/usr/bin/env python3
"""Compare packed_cosine_count with its previous design, on one CUDA card.

    python3 tools/packed_count_ab.py [--quick]

The previous design -- the first port's 128 x 128 tile, one POPC per word pair -- is
kept in `tools/packed_count_baseline.cu` and built beside this checkout's
library; so are variants made with a define or from a copy of the sources:

  - "previous, no stores" / "previous, stores only": its count stores
    compiled away, or its popcounts (the same for "this, no stores" / "this,
    stores only", from a copy of `csrc/packed_cosine.cu`);
  - "this, one POPC a word": this layout with the carry-save tree replaced
    by one POPC per word pair, the previous arithmetic;
  - "this, streaming stores": the counts stored with `st.global.cs`;
  - "this, 4 blocks an SM": the launch bound at four blocks of 256 threads;
  - "this, data tiles fastest": consecutive blocks on consecutive data tiles
    (one query tile's output rows written by many blocks at once);
  - "this, 2 data rows a thread": 512 data rows a block;
  - "this, 16 / 64 / 128 query rows a block": other query tiles (32 is
    this checkout's).

Then, for each library: what ptxas reported for the count kernel
(registers, spills) and its count bodies' SASS per word pair, by opcode and
pipe (`chip_smoke.sass_count_bodies`); and the kernels timed in turns (a, b,
..., b, a) at the SIFT per-segment shape (Q = 1024, N = 281,250, V = 238,
W = 8: random signs packed as the index packs them, half the queries data
rows with a tenth of their signs flipped), with the SM clock while each
runs and the popcount floor at that clock, each exact result held against
the plain version bit for bit; beside them the [Q, N] int32 write alone
(`Tensor.fill_` of the output), the least a store of the counts takes.

It also probes route (a) of the redesign, binary tensor cores: one kernel
per operation, `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`
and `.xor.popc`, is built with nvcc for sm_90a (whether ptxas takes it is
the first finding) and, if it builds, timed issuing four independent chains
of the instruction a warp, 8 warps a block, 16 blocks an SM: the rate in
instructions and in (query, data) pairs of W = 8 per SM-clock (one m16n8k256
covers 16 x 8 pairs of 256 bits).

--quick: the previous design and this checkout's at the segment shape only
(what chip_smoke.py's phase 5b prints).

    python3 tools/packed_count_ab.py --search [OTHER_DIR]

The PACKED simhash multiload search of chip_smoke.py's phase 4g (the SIFT
corpus in 16 segments, `SegmentedIndex.search_multiload`, 16 launches of
packed_cosine_count a search) with this checkout's count kernel and with
the previous design swapped in, in turns (previous, this, this, previous),
9 searches each; with OTHER_DIR (an unpacked checkout of another commit,
`git archive`), the same search run there and here, each in a process of
its own, in turns (other, this, this, other).  Prints one JSON line per
measurement and the card's name and power limit.  Needs one CUDA device and
nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tools import range_ptan_ab as rp  # noqa: E402

BASELINE = ROOT / "tools" / "packed_count_baseline.cu"
OUT_DIR = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "packed_count_ab"
Q, SIFT_N, SIFT_V = 1024, 281_250, 238
SRC = "packed_cosine.cu"
KERNEL = "packed_cosine_count_kernel"
# (file, pattern, replacement) edits made in a copy of csrc/ before the build
NO_STORES = (SRC, r"if \(n < n_data\) (row\[n\] = )", r"if (n < n_data && dis[j] == -w) \1")
STORES_ONLY = (SRC, r"dis\[j\] = disagree8\(qa, qb, d\[j\]\);", "dis[j] = 0 * (int)qa.x;")
ONE_POPC = (SRC, r"const unsigned s1 = xor3[\s\S]*?return __popc\(ones\)[^;]*;",
            "return __popc(x0) + __popc(x1) + __popc(x2) + __popc(x3) + __popc(x4) + "
            "__popc(x5) + __popc(x6) + __popc(x7);")
STREAMING = (SRC, r"if \(n < n_data\) row\[n\] = (\(k0 == 0 \? 32 \* w : row\[n\]\) - dis\[j\]);",
             r"if (n < n_data) __stcs(row + n, \1);")
FOUR_BLOCKS = (SRC, r"__launch_bounds__\(THREADS, 3\)\npacked_cosine_count_kernel",
               "__launch_bounds__(THREADS, 4)\npacked_cosine_count_kernel")
# consecutive blocks on consecutive data tiles of one query tile
DATA_FASTEST = [(SRC, r"const int q0 = \(int\)\(blockIdx\.x % n_qtiles\) \* TQ;",
                 "const long long n_nt = (n_data + TN - 1) / TN;\n"
                 "  const int q0 = (int)(blockIdx.x / n_nt) * TQ;"),
                (SRC, r"\(long long\)\(blockIdx\.x / n_qtiles\) \* TN",
                 "(long long)(blockIdx.x % n_nt) * TN")]
TWO_ROWS = (SRC, r"constexpr int RN = 4;", "constexpr int RN = 2;")
QUERY_TILE = {rows: (SRC, r"constexpr int TQ = \d+;", f"constexpr int TQ = {rows};")
              for rows in (16, 64, 128)}
VARIANTS = [
    ("previous", BASELINE.name, [], []),
    ("previous, no stores", BASELINE.name, ["-DBASELINE_NO_STORES"], []),
    ("previous, stores only", BASELINE.name, ["-DBASELINE_STORES_ONLY"], []),
    ("this, no stores", SRC, [], [NO_STORES]),
    ("this, stores only", SRC, [], [STORES_ONLY]),
    ("this, one POPC a word", SRC, [], [ONE_POPC]),
    ("this, streaming stores", SRC, [], [STREAMING]),
    ("this, 4 blocks an SM", SRC, [], [FOUR_BLOCKS]),
    ("this, data tiles fastest", SRC, [], DATA_FASTEST),
    ("this, 2 data rows a thread", SRC, [], [TWO_ROWS]),
] + [(f"this, {rows} query rows a block", SRC, [], [edit]) for rows, edit in QUERY_TILE.items()]
QUICK = ("previous",)

MMA_SOURCE = r"""
#include <cuda_runtime.h>
constexpr int CH = 4;
__global__ void __launch_bounds__(256) b1_probe(int* out, unsigned seed, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 13 + i);
  int c[CH][4];
  for (int h = 0; h < CH; ++h)
    for (int e = 0; e < 4; ++e) c[h][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int h = 0; h < CH; ++h)
      asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.%OP% "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+r"(c[h][0]), "+r"(c[h][1]), "+r"(c[h][2]), "+r"(c[h][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int s = 0;
  for (int h = 0; h < CH; ++h)
    for (int e = 0; e < 4; ++e) s += c[h][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(void* out, unsigned seed, int iters, int blocks, void* stream) {
  b1_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)out, seed, iters);
  return (int)cudaGetLastError();
}
"""
MMA_CHAINS, MMA_ITERS, MMA_BLOCKS_PER_SM = 4, 4096, 16


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def word_pairs(ops, full) -> int:
    """Word pairs a packed COSINE count body sums: two a POPC where the body
    runs the carry-save tree (four LOP3s a POPC: 16 LOP3 and 4 POPC per
    eight words), one a POPC where it pops every xor word."""
    return (2 if ops["LOP3"] >= 3 * ops["POPC"] else 1) * ops["POPC"]


# a packed count body sums a few rows' words (32 word pairs: four rows of W = 8)
word_pairs.min_pairs = 32


class Entry:
    """A library's packed_cosine_count as a function of CUDA tensors."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, "baseline_packed_cosine_count", None) or lib.repro_packed_cosine_count
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        self.fn, self.path = fn, path

    def __call__(self, dw: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
        (n, w), q = dw.shape, qw.shape[0]
        out = torch.empty((q, n), dtype=torch.int32, device=dw.device)
        status = self.fn(dw.data_ptr(), qw.data_ptr(), out.data_ptr(), n, q, w,
                         torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"packed_cosine_count launch ({self.path.name}): {status}")
        return out


def previous_entry() -> Entry:
    """The previous design's count kernel, built from the baseline source."""
    return Entry(rp.build_variants(QUICK, VARIANTS, BASELINE, OUT_DIR)["previous"][0])


def sift_words(device: torch.device, n: int = SIFT_N, v: int = SIFT_V, q: int = Q):
    """(data, queries) packed sign words [n, W], [q, W]: random signs, half
    the queries data rows with a tenth of their signs flipped."""
    from repro_torch.core import packing

    gen = torch.Generator(device=device).manual_seed(cs.SEED + 17)
    d = torch.randint(0, 2, (n, v), generator=gen, device=device, dtype=torch.int8) * 2 - 1
    s = torch.randint(0, 2, (q, v), generator=gen, device=device, dtype=torch.int8) * 2 - 1
    s[::2] = d[torch.arange(0, q, 2, device=device) * 997 % n]
    flip = torch.rand(s.shape, generator=gen, device=device) < 0.1
    s[flip] = -s[flip]
    return packing.pack_signs_data(d), packing.pack_signs_queries(s)


def exact(name: str) -> bool:
    return "stores only" not in name and "no stores" not in name


def count_ab(entries: dict, dw: torch.Tensor, qw: torch.Tensor, device: torch.device,
             clocks: bool = True) -> dict:
    """packed_cosine_count of each entry on words dw [N, W], qw [Q, W], in
    turns, each exact one equal to the plain version; with the SM clock while
    each runs, the pairs per SM-clock and the popcount floor at that clock."""
    from repro_torch.kernels.packed_cosine import packed_cosine_count_plain

    want = packed_cosine_count_plain(dw, qw)
    times = {name: [] for name in entries}
    for name in list(entries) + list(entries)[::-1]:
        ms, got = cs.timed_ms(lambda e=entries[name]: e(dw, qw), device, reps=5, warmup=1)
        cs.check(not exact(name) or torch.equal(got, want), f"{name} differs from the plain "
                                                            f"version")
        times[name].append(ms)
        del got
    del want
    (n, w), q = dw.shape, qw.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=device)
    fill_ms, _ = cs.timed_ms(lambda: out.fill_(7), device, reps=5, warmup=1)
    del out
    rec = dict(kernel="packed_cosine_count", Q=q, N=n, W=w, ms=times,
               bytes_bound_ms=((n + q) * w + q * n) * 4 / cs.PEAK_BYTES_PER_S * 1e3,
               write_alone_fill_ms=fill_ms)
    if clocks:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clk = {name: cs.sm_clock_mhz(lambda e=e: e(dw, qw), device) for name, e in entries.items()}
        rec["sm_clock_mhz"] = clk
        rec["pairs_per_sm_clock"] = {name: cs.pairs_per_sm_clock(q * n, min(times[name]), clk[name])
                                     for name in entries}
        rec["popc_floor_ms"] = {name: (q * n * w / (cs.POPC_PER_SM_CLOCK * sms * c * 1e6) * 1e3
                                       if c else None) for name, c in clk.items()}
    emit(**rec)
    return rec


def sass_of(lib: Path, kernel: str) -> list:
    from repro_torch.kernels import build

    sass = build.sass(lib)
    if not any(f"{len(kernel)}{kernel}" in n for n in sass):
        return []
    return cs.sass_count_bodies(sass, kernel, word_pairs)


def mma_probe(device: torch.device) -> list:
    """Route (a): build and time the binary mma.sync of each operation."""
    from repro_torch.kernels import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for op in ("and.popc", "xor.popc"):
        tag = op.replace(".", "_")
        src, lib = OUT_DIR / f"b1_{tag}.cu", OUT_DIR / f"b1_{tag}.so"
        src.write_text(MMA_SOURCE.replace("%OP%", op))
        procs[op] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                                            str(src)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    records = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for op, (lib, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        rec = dict(probe=f"mma.sync m16n8k256 b1 {op}", builds=proc.returncode == 0,
                   ptxas=[line.strip() for line in text.splitlines()
                          if "error" in line or "registers" in line][:6])
        if proc.returncode == 0:
            fn = ctypes.CDLL(str(lib)).probe_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            blocks = sms * MMA_BLOCKS_PER_SM
            out = torch.empty(blocks * 256, dtype=torch.int32, device=device)

            def run():
                status = fn(out.data_ptr(), 12345, MMA_ITERS, blocks,
                            torch.cuda.current_stream().cuda_stream)
                cs.check(status == 0, f"b1 probe launch: {status}")

            ms, _ = cs.timed_ms(run, device, reps=3, warmup=1)
            clock = cs.sm_clock_mhz(run, device)
            mmas = blocks * 8 * MMA_ITERS * MMA_CHAINS
            per = mmas / (ms * 1e-3) / sms / (clock * 1e6) if clock else None
            rec.update(ms=ms, sm_clock_mhz=clock, mma_per_sm_clock=per,
                       pairs_w8_per_sm_clock=per * 128 if per else None,
                       popc_route_pairs_w8_per_sm_clock=cs.POPC_PER_SM_CLOCK / 8)
        emit(**rec)
        records.append(rec)
    return records


def packed_multiload_times(device: torch.device, n_searches: int = 9) -> dict:
    """The PACKED simhash multiload search of chip_smoke.py's phase 4g
    alone: the SIFT corpus through
    RetrievalService(scheme="simhash", signature_layout="packed"), then
    `n_searches` timed SegmentedIndex.search_multiload calls."""
    run = cs.drive_full_width(device, {"packed_cosine_topk": cs.FULL_SEGMENTS}, (-1.0, 1.0),
                              scheme="simhash", signature_layout="packed", n_searches=1)
    index, qsigs = run["service"]._index, run["qsigs"]
    ms = [cs.timed_ms(lambda: index.search_multiload(qsigs, k=cs.FULL_K), device)[0]
          for _ in range(n_searches)]
    del run, index
    torch.cuda.empty_cache()
    return dict(ms=ms, median_ms=statistics.median(ms))


# run in another checkout's root: that checkout's chip_smoke.py and
# repro_torch, this tool's packed_multiload_times
SEARCH_RUN = """
import json, statistics, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as cs
{function}
device = torch.device('cuda', 0)
ms = packed_multiload_times(device, n_searches=9)
print('SEARCH ' + json.dumps(ms))
"""


def search_ab(other: Path | None) -> int:
    """The PACKED simhash multiload search with the previous count kernel
    swapped in and with this one, in turns; with `other`, also that
    checkout's against this one."""
    from repro_torch.kernels import ops

    device = torch.device("cuda", 0)
    previous, this = previous_entry(), ops.packed_cosine_count
    runs = {"previous": [], "this": []}
    for side in ("previous", "this", "this", "previous"):
        ops.packed_cosine_count = previous if side == "previous" else this
        rec = packed_multiload_times(device, n_searches=9)
        runs[side].append(rec["median_ms"])
        emit(count_kernel=side, **rec)
    ops.packed_cosine_count = this
    emit(packed_multiload_search_median_ms=runs)
    if other is not None:
        medians = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            tree = other if side == "other" else ROOT
            run = SEARCH_RUN.format(function=inspect.getsource(packed_multiload_times))
            out = subprocess.run([sys.executable, "-c", run], cwd=tree,
                                 capture_output=True, text=True, timeout=900)
            cs.check(out.returncode == 0, f"{side}: the search failed:\n{out.stdout[-3000:]}"
                                          f"\n{out.stderr[-3000:]}")
            rec = json.loads(next(line for line in out.stdout.splitlines()
                                  if line.startswith("SEARCH "))[len("SEARCH "):])
            medians[side].append(rec["median_ms"])
            emit(side=side, tree=str(tree), **rec)
        emit(packed_multiload_search_median_ms=medians)
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 1
    if args[:1] == ["--search"] and len(args) <= 2:
        return search_ab(Path(args[1]).resolve() if len(args) == 2 else None)
    quick = args == ["--quick"]
    if args and not quick:
        print(__doc__, file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    built = rp.build_variants(QUICK if quick else [v[0] for v in VARIANTS], VARIANTS,
                              BASELINE, OUT_DIR)
    built["this"] = (build.build(), build.build_log())
    for name, (lib, text) in built.items():
        kernel = ("baseline_" if name.startswith("previous") else "") + KERNEL
        emit(library=name, ptxas=rp.ptxas_of(text, kernel), sass=sass_of(lib, kernel))
    order = ["previous", "this"] + [n for n in built if n not in ("previous", "this")]
    entries = {name: Entry(built[name][0]) for name in order}
    dw, qw = sift_words(device)
    count_ab(entries, dw, qw, device)
    if not quick:
        mma_probe(device)
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
