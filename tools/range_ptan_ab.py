#!/usr/bin/env python3
"""Compare range_count and packed_tanimoto_count with their previous design,
on one CUDA card.

    python3 tools/range_ptan_ab.py [--quick]

The previous design of both kernels -- the templated int32 count tile of
`csrc/eq_tile.cuh` -- is kept in `tools/range_ptan_baseline.cu` and built
from it beside this checkout's library; so are variants made with a define
or from a copy of the sources:

  - "previous, stores only" / "previous, no stores": range_count's tests
    compiled away, or its count stores (the same for "this, stores only" /
    "this, no stores", from a copy of `range_count.cu`);
  - range_count with blocks of 256 threads (64 query rows), four an SM;
  - packed_tanimoto_count with one block of 512 threads an SM, with blocks
    of 256 threads (64 query rows), four an SM, and with chunks of 64
    columns (one barrier per 64, the tiles in dynamic shared memory).

Then, for each library: what ptxas reported for the two kernels (registers,
shared memory, spills) and their count bodies' SASS per test or pair, by
opcode and pipe (`chip_smoke.sass_count_bodies`); and the kernels timed in
turns (a, b, ..., b, a) with the SM clock while they run, each result held
against the plain version bit for bit:

  - range_count at Adult's per-segment shape (Q = 1024, N = 61,250, d = 14:
    Gaussian tuples in 1024 bins, ranges +-50 around tuples of the segment),
    and the torch.stack of lo and hi the previous wrapper made per call; then
    at N = 61,248, where every output row starts on a 16-byte boundary;
  - packed_tanimoto_count at the SIFT per-segment shape (Q = 1024, N =
    281,250, m = 238 minhash ids in [0, 254), half the queries data rows with
    a tenth of their ids redrawn) and at m = 4096, N = 16,384, beside
    tanimoto_count (the WIDE equality tile) on the same ids.

--quick: the two previous kernels and this checkout's at the main shapes
only (what chip_smoke.py's phases 5c and 5d print).

    python3 tools/range_ptan_ab.py --search OTHER_DIR

The Adult -> RANGE search of chip_smoke.py's phase 4d (980,000 tuples in 16
segments, 1024 queries, k = 100) run in this checkout and in OTHER_DIR (an
unpacked checkout of another commit, `git archive`), each in a process of its
own, in turns (other, this, this, other): the phase's own first and median
search times and 9 more searches timed after it, as one JSON line a run.  Prints one JSON line
per measurement and the card's name and power limit.  Needs one CUDA device
and nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BASELINE = ROOT / "tools" / "range_ptan_baseline.cu"
OUT_DIR = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "range_ptan_ab"
Q = 1024
ADULT_N, ADULT_D = cs.ADULT_N // cs.SA_SEGMENTS, cs.ADULT_D
SIFT_N, SIFT_M = 281_250, 238
FLASH_N, FLASH_M = 16_384, 4096
# (name, source, defines, edits): edits are (file, pattern, replacement) made in
# a copy of csrc/ (and of the baseline) before the build
STORE_GUARD = (r"if \(n < n_data\) (out\[\(long long\)q \* n_data \+ n\] = acc\[i\]\[j\];)",
               r"if (n < n_data && acc[i][j] == -7) \1")
NO_TESTS = ("range_count.cu", r"test[12]\(acc\[[^;]*\);", ";")
NO_STORES = ("range_count.cu", r"if \(n < n_data\) (row\[n\] = )",
             r"if (n < n_data && acc[i][j] == 7u) \1")
# 256 threads a block (64 query rows), four blocks an SM
QUARTER_BLOCKS = [("range_count.cu", r"constexpr int THREADS = 512;( +)// 16 warps",
                   r"constexpr int THREADS = 256;\1// 8 warps"),
                  ("range_count.cu", r"__launch_bounds__\(THREADS, 2\)",
                   "__launch_bounds__(THREADS, 4)")]
ONE_BLOCK_PTAN = ("packed_tanimoto.cu",
                  r"__launch_bounds__\(THREADS, 2\)\npacked_tanimoto_count_kernel",
                  "__launch_bounds__(THREADS, 1)\npacked_tanimoto_count_kernel")
# chunks of 64 columns (32 float16 words a row): one barrier per 64 columns;
# the double-buffered tiles (69,632 bytes) in dynamic shared memory
WIDE_CHUNKS = [
    ("packed_tanimoto.cu", r"constexpr int KH = 16;", "constexpr int KH = 32;"),
    ("packed_tanimoto.cu", r"(constexpr int FLUSH_CHUNKS = [^\n]*\n)",
     r"\1constexpr int SMEM = 2 * (TQ + TN) * LD * 4;\n"),
    ("packed_tanimoto.cu",
     re.escape("  __shared__ __align__(16) unsigned q_s[2][TQ * LD];\n"
               "  __shared__ __align__(16) unsigned d_s[2][TN * LD];"),
     "  extern __shared__ __align__(16) unsigned smem_count[];\n"
     "  unsigned (*q_s)[TQ * LD] = reinterpret_cast<unsigned (*)[TQ * LD]>(smem_count);\n"
     "  unsigned (*d_s)[TN * LD] =\n"
     "      reinterpret_cast<unsigned (*)[TN * LD]>(smem_count + 2 * TQ * LD);"),
    ("packed_tanimoto.cu",
     re.escape("  count::packed_tanimoto_count_kernel<<<(unsigned)blocks, count::THREADS, 0,"),
     "  cudaFuncSetAttribute(count::packed_tanimoto_count_kernel,\n"
     "                       cudaFuncAttributeMaxDynamicSharedMemorySize, count::SMEM);\n"
     "  count::packed_tanimoto_count_kernel<<<(unsigned)blocks, count::THREADS, count::SMEM,")]
HALF_BLOCK_PTAN = [("packed_tanimoto.cu", r"constexpr int TY = 16;( +// threads along Q)",
                    r"constexpr int TY = 8;\1"),
                   ("packed_tanimoto.cu",
                    r"__launch_bounds__\(THREADS, 2\)\npacked_tanimoto_count_kernel",
                    "__launch_bounds__(THREADS, 4)\npacked_tanimoto_count_kernel")]
VARIANTS = [
    ("previous", "range_ptan_baseline.cu", [], []),
    ("previous, stores only", "range_ptan_baseline.cu", ["-DBASELINE_NO_COMPARE"], []),
    ("previous, no stores", "range_ptan_baseline.cu", [], [("eq_tile.cuh", *STORE_GUARD)]),
    ("this, stores only", "range_count.cu", [], [NO_TESTS]),
    ("this, no stores", "range_count.cu", [], [NO_STORES]),
    ("this, 256 threads", "range_count.cu", [], QUARTER_BLOCKS),
    ("this, 256 threads, no stores", "range_count.cu", [], QUARTER_BLOCKS + [NO_STORES]),
] + [
    ("this, one block an SM", "packed_tanimoto.cu", [], [ONE_BLOCK_PTAN]),
    ("this, 64-column chunks", "packed_tanimoto.cu", [], WIDE_CHUNKS),
    ("this, 256 threads, 4 blocks an SM", "packed_tanimoto.cu", [], HALF_BLOCK_PTAN)]
QUICK = ("previous",)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def build_variants(names, variants=None, baseline: Path = BASELINE,
                   out_dir: Path = OUT_DIR) -> dict:
    """Compile each named variant of `variants` (default VARIANTS) into
    out_dir/<name>.so (reused when it is there and newer than its sources),
    all nvcc processes started together; a variant's source is a file of
    csrc/ or the baseline beside it.  Returns name -> (library path, ptxas
    output)."""
    from repro_torch.kernels import build

    nvcc = build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    newest = max(p.stat().st_mtime for p in [baseline, *CSRC.iterdir()])
    procs, out = {}, {}
    for name, source, defines, edits in VARIANTS if variants is None else variants:
        if name not in names:
            continue
        tag = re.sub(r"\W+", "_", name)
        lib = out_dir / f"{tag}.so"
        log = out_dir / f"{tag}.log"
        if lib.exists() and log.exists() and lib.stat().st_mtime > newest:
            out[name] = (lib, log.read_text())
            continue
        src_dir = CSRC
        if edits:
            src_dir = out_dir / tag
            if src_dir.exists():
                shutil.rmtree(src_dir)
            shutil.copytree(CSRC, src_dir)
            shutil.copy(baseline, src_dir)
            for file, pattern, repl in edits:
                text, n = re.subn(pattern, repl, (src_dir / file).read_text())
                cs.check(n > 0, f"variant {name}: no match for {pattern} in {file}")
                (src_dir / file).write_text(text)
        src = src_dir / source if (src_dir / source).exists() else baseline
        cmd = [nvcc, *build.NVCC_FLAGS, *defines, f"-I{src_dir}", "-shared", "-o", str(lib),
               str(src)]
        procs[name] = (lib, log, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    for name, (lib, log, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        cs.check(proc.returncode == 0, f"build of {name} failed:\n{text}")
        log.write_text(text)
        out[name] = (lib, text)
    return out


def ptxas_of(text: str, kernel: str) -> list:
    lines, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = f"{len(kernel)}{kernel}" in line
        if keep and ("registers" in line or "spill" in line or "Compiling" in line):
            lines.append(line.strip())
    return lines


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Entries:
    """The count entries of one library as functions of CUDA tensors: the
    previous design's (`baseline_*`, lo and hi stacked beforehand) or this
    checkout's (`repro_*`)."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.baseline = hasattr(lib, "baseline_range_count")
        self.range_fn = self.ptan_fn = None
        if self.baseline:
            self.range_fn = lib.baseline_range_count
            self.ptan_fn = lib.baseline_packed_tanimoto_count
            self.range_fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        elif hasattr(lib, "repro_range_count"):
            self.range_fn = lib.repro_range_count
            self.range_fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        if hasattr(lib, "repro_packed_tanimoto_count"):
            self.ptan_fn = lib.repro_packed_tanimoto_count
        if self.ptan_fn is not None:
            self.ptan_fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]

    def range_count(self, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    lohi: torch.Tensor | None = None) -> torch.Tensor:
        n, d = x.shape
        q = lo.shape[0]
        out = torch.empty((q, n), dtype=torch.int32, device=x.device)
        if self.baseline:
            lohi = torch.stack([lo, hi], dim=-1) if lohi is None else lohi
            status = self.range_fn(x.data_ptr(), lohi.data_ptr(), out.data_ptr(), n, q, d,
                                   stream())
        else:
            status = self.range_fn(x.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                                   n, q, d, stream())
        cs.check(status == 0, f"range_count launch: {status}")
        return out

    def packed_tanimoto_count(self, du: torch.Tensor, qu: torch.Tensor) -> torch.Tensor:
        n, m = du.shape
        q = qu.shape[0]
        out = torch.empty((q, n), dtype=torch.int32, device=du.device)
        status = self.ptan_fn(du.data_ptr(), qu.data_ptr(), out.data_ptr(), n, q, m, stream())
        cs.check(status == 0, f"packed_tanimoto_count launch: {status}")
        return out


def previous_entries_path() -> Path:
    """The previous design's library, built from the baseline source."""
    return build_variants(QUICK)["previous"][0]


def previous_entries() -> Entries:
    """The previous design's two kernels."""
    return Entries(previous_entries_path())


def adult_segment(device: torch.device, n: int = ADULT_N, q: int = Q):
    """(tuples int32 [n, 14], lo, hi int32 [q, 14]) of one Adult segment:
    Gaussian tuples discretised into 1024 bins, ranges +-50 around q tuples
    of the segment (relational.point_range_queries), as phase 4d draws them."""
    import numpy as np

    from repro_torch.core.sa import relational

    vals = np.random.default_rng(cs.SEED).standard_normal((n, ADULT_D))
    tuples = relational.fit_discretizer(vals, n_bins=cs.ADULT_BINS).transform(vals)
    picks = (np.arange(q) * 997) % n
    lo, hi = relational.point_range_queries(tuples[picks], radius=cs.ADULT_RADIUS,
                                            n_bins=cs.ADULT_BINS)
    return (torch.from_numpy(np.ascontiguousarray(tuples, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(lo, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(hi, np.int32)).to(device))


def minhash_ids(device: torch.device, n: int, m: int, q: int = Q):
    """(data, queries) int32 ids in [0, 254): half the queries data rows with
    a tenth of their ids redrawn, the rest random."""
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 13)
    d = torch.randint(0, 254, (n, m), generator=gen, device=device, dtype=torch.int32)
    s = torch.randint(0, 254, (q, m), generator=gen, device=device, dtype=torch.int32)
    s[::2] = d[torch.arange(0, q, 2, device=device) * 997 % n]
    redraw = torch.rand(s.shape, generator=gen, device=device) < 0.1
    s[redraw] = torch.randint(0, 254, (int(redraw.sum()),), generator=gen, device=device,
                              dtype=torch.int32)
    return d, s


def exact(name: str) -> bool:
    """Whether a library's kernel computes the counts (a variant with its
    tests or its stores removed does not)."""
    return "stores only" not in name and "no stores" not in name


def in_turns(fns: dict, want: torch.Tensor, device: torch.device, reps: int,
             hold: bool) -> dict:
    """Time each fn in the order a, b, ..., b, a, each exact one's result
    equal to `want`; return name -> [ms, ms]."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms, got = cs.timed_ms(fns[name], device, reps=reps, warmup=1, hold=hold)
        cs.check(not exact(name) or torch.equal(got, want),
                 f"{name} differs from the plain version")
        times[name].append(ms)
        del got
    return times


def clocks_and_rates(fns: dict, work: float, times: dict, device: torch.device) -> tuple:
    clocks = {name: cs.sm_clock_mhz(fn, device) for name, fn in fns.items()}
    rates = {name: cs.pairs_per_sm_clock(work, min(times[name]), clocks[name])
             for name in fns}
    return clocks, rates


def range_ab(entries: dict, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             device: torch.device, clocks: bool = True) -> dict:
    """range_count of each library on tuples x [N, d] and intervals lo, hi
    [Q, d], in turns; the previous design is given lo and hi stacked
    beforehand, and the stack is timed on its own."""
    from repro_torch.kernels.range_count import range_count_plain

    lohi = torch.stack([lo, hi], dim=-1)
    want = range_count_plain(x, lo, hi)
    fns = {name: (lambda e=e: e.range_count(x, lo, hi, lohi)) for name, e in entries.items()
           if e.range_fn is not None}
    times = in_turns(fns, want, device, reps=10, hold=True)
    stack_ms, _ = cs.timed_ms(lambda: torch.stack([lo, hi], dim=-1), device, reps=10,
                              warmup=1, hold=True)
    (n, d), q = x.shape, lo.shape[0]
    rec = dict(kernel="range_count", Q=q, N=n, d=d, ms=times, stack_ms=stack_ms,
               bytes_bound_ms=(n * d + 2 * q * d + q * n) * 4 / cs.PEAK_BYTES_PER_S * 1e3)
    if clocks:
        rec["sm_clock_mhz"], rec["tests_per_sm_clock"] = clocks_and_rates(fns, q * n * d, times,
                                                                          device)
    emit(**rec)
    return rec


def ptan_ab(entries: dict, d: torch.Tensor, s: torch.Tensor, device: torch.device,
            clocks: bool = True) -> dict:
    """packed_tanimoto_count of each library on ids d [N, m], s [Q, m] in
    [0, 254) packed to bytes, and tanimoto_count (this checkout's WIDE tile)
    on the ids themselves, in turns."""
    from repro_torch.core import packing
    from repro_torch.kernels import ops
    from repro_torch.kernels.packed_tanimoto import packed_tanimoto_count_plain

    (n, m), q = d.shape, s.shape[0]
    du, su = packing.pack_buckets(d), packing.pack_buckets(s)
    want = ops.tanimoto_count(d, s)
    cs.check(torch.equal(want, packed_tanimoto_count_plain(du, su)),
             "tanimoto_count differs from the packed plain version")
    fns = {name: (lambda e=e: e.packed_tanimoto_count(du, su)) for name, e in entries.items()
           if e.ptan_fn is not None}
    fns["tanimoto_count (WIDE)"] = lambda: ops.tanimoto_count(d, s)
    times = in_turns(fns, want, device, reps=3 if m > 1000 else 5, hold=False)
    rec = dict(kernel="packed_tanimoto_count", Q=q, N=n, m=m, ms=times)
    if clocks:
        rec["sm_clock_mhz"], rec["pairs_per_sm_clock"] = clocks_and_rates(fns, q * n * m, times,
                                                                          device)
    emit(**rec)
    del du, su, want
    torch.cuda.empty_cache()
    return rec


def sass_of(lib: Path, kernel: str, pairs_of) -> list:
    from repro_torch.kernels import build

    sass = build.sass(lib)
    if not any(f"{len(kernel)}{kernel}" in n for n in sass):
        return []
    return cs.sass_count_bodies(sass, kernel, pairs_of)


SEARCH_RUN = """
import json, statistics, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as cs
from repro_torch.core import TopKMethod
device = torch.device('cuda', 0)
run = cs.phase_full_width_adult(device)
index, queries = run['index'], run['queries']
ms = [cs.timed_ms(lambda: index.search(queries, k=cs.FULL_K, method=TopKMethod.CPQ), device)[0]
      for _ in range(9)]
print('SEARCH ' + json.dumps({'ms': ms, 'median_ms': statistics.median(ms)}))
"""


def search_ab(other: Path) -> int:
    """The Adult -> RANGE search in both checkouts, in turns."""
    medians = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        tree = other if side == "other" else ROOT
        out = subprocess.run([sys.executable, "-c", SEARCH_RUN], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        cs.check(out.returncode == 0, f"{side}: the Adult run failed:\n{out.stdout[-3000:]}"
                                      f"\n{out.stderr[-3000:]}")
        phase = [line.strip() for line in out.stdout.splitlines() if "search: first" in line]
        rec = json.loads(next(line for line in out.stdout.splitlines()
                              if line.startswith("SEARCH "))[len("SEARCH "):])
        medians[side].append(rec["median_ms"])
        emit(side=side, tree=str(tree), phase_4d=phase, **rec)
    emit(adult_search_median_ms=medians)
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--search"] and len(sys.argv) == 3 and torch.cuda.is_available():
        return search_ab(Path(sys.argv[2]).resolve())
    quick = "--quick" in sys.argv[1:]
    if [a for a in sys.argv[1:] if a != "--quick"] or not torch.cuda.is_available():
        print(__doc__ if torch.cuda.is_available() else "needs one CUDA device",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    built = build_variants(QUICK if quick else [v[0] for v in VARIANTS])
    built["this"] = (build.build(), build.build_log())
    for name, (lib, text) in built.items():
        kernels = {"range": ("baseline_range_count_kernel" if name.startswith("previous")
                             else "range_count_kernel", cs.range_pairs),
                   "packed": ("baseline_packed_tanimoto_count_kernel"
                              if name.startswith("previous") else
                              "packed_tanimoto_count_kernel", cs.eq_pairs)}
        emit(library=name, ptxas={k: ptxas_of(text, kern) for k, (kern, _) in kernels.items()},
             sass={k: sass_of(lib, kern, rule) for k, (kern, rule) in kernels.items()})
    entries = {name: Entries(lib) for name, (lib, _) in built.items()}
    order = ["previous", "this"] + [n for n in entries if n not in ("previous", "this")]
    entries = {name: entries[name] for name in order}
    ranges = {n: e for n, e in entries.items() if e.range_fn is not None}
    x, lo, hi = adult_segment(device)
    range_ab(ranges, x, lo, hi, device)
    if not quick:                          # N = 61,248: every output row 16-byte aligned
        range_ab(ranges, x[:ADULT_N - 2], lo, hi, device)
    ptan = {n: e for n, e in entries.items() if e.ptan_fn is not None and "stores" not in n}
    for n, m in ((SIFT_N, SIFT_M),) + (() if quick else ((FLASH_N, FLASH_M),)):
        d, s = minhash_ids(device, n, m)
        ptan_ab(ptan, d, s, device)
        del d, s
        torch.cuda.empty_cache()
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
