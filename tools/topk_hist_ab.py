#!/usr/bin/env python3
"""Trace and compare the fused COSINE top-k kernel and the c-PQ histogram
kernel of this checkout (and of another one), on one CUDA card.

    python3 tools/topk_hist_ab.py [OTHER_DIR] [--sass-dir=DIR]

OTHER_DIR holds an unpacked checkout of another commit (`git archive`).
From each checkout's `src/repro_torch/kernels/csrc`, `packed_cosine.cu`,
`packed_tanimoto.cu` and `cpq_hist.cu` are compiled with nvcc into a small
library of their own, together with variants built from a copy of the
sources:

  - "count only": the fused kernels with their per-row selection call
    removed (the stage split: counting against counting plus selection);
  - "no ties, no list" and "no list placement" (where the source has them):
    parts of the selection's pass 4 removed (list_and_ties, place_list);
  - "count only, no histogram": the selection and the histogram adds of the
    count write-back removed;
  - "two-byte tile" (where the source has the constant `MAX_W_ONE_BYTE`): the
    fused kernel with its one-byte count tile switched off, so that W = 8
    takes the two-byte tile of 32 query rows.

Then, for each library:

  - what ptxas reported for the kernels (registers, shared memory, spills),
    and their SASS: the instructions of the count loop per word pair (one
    `POPC` a pair) and of the histogram's main loop per counted element (its
    global loads' bytes / 4), by opcode and pipe; with --sass-dir, the SASS
    of the fused and histogram kernels is written there, a file a kernel;
  - `repro_packed_cosine_topk` and `repro_packed_tanimoto_topk` at the SIFT
    per-segment shape (Q = 1024, N = 281,250, 238 signs in W = 8 words /
    238 one-byte minhash ids, k = 100), timed in turns (other, this, this,
    other) with the SM clock while they run, their buffers held against the
    plain versions;
  - `repro_cpq_hist` on each path's real counts at its per-segment shape:
    e2lsh -> EQ on SIFT (N = 281,250, 239 bins), Adult -> RANGE (61,250, 15),
    DBLP -> MINSUM (62,500, 128), Tweets -> IP (62,500, 17), each made by one
    segment of chip_smoke.py's full-width phase, timed in turns as the wrapper
    calls it (a kernel whose output must start zero is given torch.zeros, the
    other torch.empty), bit-equal to the plain version.

Prints one JSON line per measurement and the card's name and power limit.
Needs one CUDA device and nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import collections
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

SOURCES = ("packed_cosine.cu", "packed_tanimoto.cu", "cpq_hist.cu")
# Variants, each an edit of a copy of the sources: (name, pattern, replacement).
# A call of the fused kernels' selection (warp_local_topk in older sources,
# warp_topk_from_histogram), or of a part of its pass 4, is removed; or the
# one-byte count tile of packed_cosine_topk is switched off.
CALL = r"(?<!void )\b(?:repro::)?{}\([^;{{]*?\);"
VARIANTS = [
    ("count only", re.compile(CALL.format(r"warp_(?:local_topk|topk_from_histogram)")), ";"),
    ("no ties, no list", re.compile(CALL.format(r"(?:list_and_ties|place_list)")), ";"),
    ("no list placement", re.compile(CALL.format("place_list")), ";"),
    ("count only, no histogram",
     re.compile(r"(?<!void )\b(?:repro::)?warp_topk_from_histogram\([^;{]*?\);"
                r"|if \(real && live\) atomicAdd\(hist[^;]*;"), ";"),
    ("two-byte tile", re.compile(r"(constexpr int MAX_W_ONE_BYTE = )\d+;"), r"\g<1>7;"),
]
Q, N_SIFT, V_SIFT, K = 1024, 281_250, 238, 100
# pipes of the opcodes in the two kernels' loops on sm_90, as chip_smoke.SASS_PIPES
PIPES = {**cs.SASS_PIPES, "POPC": "popc", "FLO": "popc", "BREV": "popc", "MATCH": "match",
         "ATOMS": "mio", "LDG": "lsu", "SHFL": "mio", "REDUX": "redux", "VOTE": "int",
         "LOP": "int", "SHL": "int", "SHR": "int", "PRMT": "int", "BMSK": "int"}
OUT_DIR = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "ab"


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def variants(label: str, csrc: Path) -> list:
    """(name, source directory) of a checkout's library and its variants,
    each variant a copy of its sources with one edit, made in the first of
    packed_cosine.cu and the fused kernel's header (fused_topk.cuh) where its
    pattern matches."""
    out = [(label, csrc)]
    for suffix, pattern, repl in VARIANTS:
        name = f"{label}, {suffix}"
        for src in ("packed_cosine.cu", "fused_topk.cuh"):
            if not (csrc / src).exists():
                continue
            edited, n = pattern.subn(repl, (csrc / src).read_text())
            if n:
                copy = OUT_DIR / re.sub(r"\W+", "_", name) / "csrc"
                if copy.exists():
                    shutil.rmtree(copy)
                shutil.copytree(csrc, copy)
                (copy / src).write_text(edited)
                out.append((name, copy))
                break
    return out


def build_all(libs: list) -> dict:
    """Compile every (name, csrc) into OUT_DIR/<name>.so, all nvcc processes
    started together; returns name -> (library path, ptxas output)."""
    from repro_torch.kernels import build

    nvcc = build.find_nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, csrc in libs:
        lib = OUT_DIR / (re.sub(r"\W+", "_", name) + ".so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(csrc / s) for s in SOURCES)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{text}")
        out[name] = (lib, text)
    return out


def ptxas_of(text: str, kernel: str) -> list:
    lines, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("registers" in line or "spill" in line or "Compiling" in line):
            lines.append(line.strip())
    return lines


def sass_loops(body: str) -> list:
    """The loops of a kernel's SASS: each backward branch at address A to T <
    A makes the instruction range [T, A] a loop.  Each loop's opcodes (with
    their modifiers, e.g. LDG.E.128) are counted outside the loops nested in
    it: what one trip of its own body runs, a branch not taken included."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in map(cs.SASS_INSTRUCTION.search,
                                                          body.splitlines()) if m]
    spans = []
    for line in body.splitlines():
        m = cs.SASS_INSTRUCTION.search(line)
        if not m or not m.group(2).startswith("BRA"):
            continue
        at = int(m.group(1), 16)
        spans += [(int(t, 16), at) for t in re.findall(r"0x([0-9a-f]+)", line.split(";")[0])
                  if int(t, 16) < at]
    loops = []
    for t, at in spans:
        inner = [(t2, a2) for t2, a2 in spans if t <= t2 and a2 <= at and (t2, a2) != (t, at)]
        loops.append(collections.Counter(
            op for a, op in ins if t <= a <= at and not any(t2 <= a <= a2 for t2, a2 in inner)))
    return loops


def loop_profile(ops: collections.Counter, units: float, unit: str) -> dict:
    base = collections.Counter()
    pipes = collections.Counter()
    for op, c in ops.items():
        b = op.split(".")[0]
        base[b] += c
        pipes[PIPES.get(b, "other")] += c
    total = sum(ops.values())
    return {"unit": unit, "units_in_loop": units, "instructions_per_unit": round(total / units, 4),
            "by_opcode": {op: round(c / units, 4) for op, c in base.most_common()},
            "by_pipe": {p: round(c / units, 4) for p, c in pipes.most_common()}}


def load_bytes(ops: collections.Counter) -> int:
    n = 0
    for op, c in ops.items():
        if op.startswith("LDG"):
            width = re.search(r"\.(128|64|U8|S8|U16|S16)\b", op)
            n += c * {"128": 16, "64": 8, "U8": 1, "S8": 1, "U16": 2, "S16": 2}.get(
                width.group(1) if width else "", 4)
    return n


def popcs(ops: collections.Counter) -> int:
    return sum(c for op, c in ops.items() if op.startswith("POPC"))


def sass_summary(lib: Path) -> dict:
    from repro_torch.kernels import build

    out = {}
    for fn, body in build.sass(lib).items():
        if "topk_kernel" in fn:
            loops = [lp for lp in sass_loops(body) if popcs(lp) >= 16]
            if loops:
                # the innermost count loop: the densest in POPC
                best = max(loops, key=lambda lp: popcs(lp) / sum(lp.values()))
                pairs = popcs(best)
                out[fn] = loop_profile(best, pairs, "word pair (POPC)")
        elif "cpq_hist" in fn:
            loops = [lp for lp in sass_loops(body) if load_bytes(lp)]
            if loops:
                best = max(loops, key=lambda lp: load_bytes(lp) / sum(lp.values()))
                out[fn] = loop_profile(best, load_bytes(best) / 4, "counted element")
    return out


class Lib:
    """The C entries of one library as functions of CUDA tensors."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("packed_cosine_topk", "packed_tanimoto_topk"):
            getattr(lib, f"repro_{name}_plan").argtypes = [
                i64, i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
            getattr(lib, f"repro_{name}").argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                                     i32, ptr, ptr]
        lib.repro_cpq_hist.argtypes = [ptr, ptr, i64, i32, i32, ptr]
        self.lib = lib

    def topk(self, name: str, d: torch.Tensor, s: torch.Tensor, k: int):
        """repro_<name> (packed_cosine_topk or packed_tanimoto_topk) as the
        wrapper launches it."""
        n, w = d.shape
        q = s.shape[0]
        kc = min(k, 2048)
        slots = -(-n // 2048) * kc
        ids = torch.empty((q, slots), dtype=torch.int32, device=d.device)
        cnts = torch.empty_like(ids)
        grid, scratch_ints = ctypes.c_int(), ctypes.c_longlong()
        cs.check(getattr(self.lib, f"repro_{name}_plan")(
            n, q, w, ctypes.byref(grid), ctypes.byref(scratch_ints)) == 0, f"{name} plan")
        scratch = (torch.empty(scratch_ints.value, dtype=torch.int32, device=d.device)
                   if scratch_ints.value else None)
        status = getattr(self.lib, f"repro_{name}")(
            d.data_ptr(), s.data_ptr(), ids.data_ptr(), cnts.data_ptr(), n, q, w, kc, grid.value,
            None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"{name} launch: {status}")
        return ids, cnts

    def hist(self, counts: torch.Tensor, nbins: int, zeroed: bool):
        q, n = counts.shape
        make = torch.zeros if zeroed else torch.empty
        out = make((q, nbins), dtype=torch.int32, device=counts.device)
        status = self.lib.repro_cpq_hist(counts.data_ptr(), out.data_ptr(), n, q, nbins,
                                         torch.cuda.current_stream().cuda_stream)
        cs.check(status == 0, f"cpq_hist launch: {status}")
        return out


def hist_needs_zeros(csrc: Path) -> bool:
    """Whether the checkout's kernel adds into an output the caller zeroes
    (older sources say so in their entry's comment) rather than writing (or
    zeroing) the output itself."""
    return "already zero" in (csrc / "cpq_hist.cu").read_text()


def path_counts(device: torch.device) -> list:
    """(label, counts [Q, N], nbins) of each path at its per-segment shape: one
    segment of chip_smoke.py's full-width phase, counted by this checkout's
    match kernel."""
    from repro_torch.kernels import ops

    out = []
    run = cs.drive_full_width(device, {"match_count": 1, "cpq_hist": 1}, (0.0, 1.0),
                              n_total=N_SIFT, n_segments=1, n_queries=Q)
    svc = run["service"]
    out.append(("e2lsh -> EQ, SIFT", ops.match_count(svc._index.segments[0].data, run["qsigs"]),
                svc.m + 1))
    del run, svc
    run = cs.phase_full_width_adult(device, n_total=cs.ADULT_N // cs.SA_SEGMENTS, n_segments=1)
    lo, hi = run["index"].model.prepare_queries(run["queries"], device)
    out.append(("Adult -> RANGE", ops.range_count(run["index"].segments[0].data, lo, hi),
                cs.ADULT_D + 1))
    run = cs.phase_full_width_dblp(device, n_total=cs.DBLP_N // cs.SA_SEGMENTS, n_segments=1,
                                   n_verify=8)
    out.append(("DBLP -> MINSUM", ops.minsum_count(run["index"].segments[0].data,
                                                   run["queries"]), cs.DBLP_MAX_COUNT + 1))
    run = cs.phase_full_width_tweets(device, n_total=cs.TWEETS_N // cs.SA_SEGMENTS,
                                     n_segments=1)
    out.append(("Tweets -> IP", ops.ip_count(run["index"].segments[0].data, run["queries"]),
                cs.TWEETS_MAX_COUNT + 1))
    del run
    torch.cuda.empty_cache()
    return out


def in_turns(names: list, fn, want_check, device: torch.device, reps: int, hold: bool) -> dict:
    """Time fn(name) for each name in the order a, b, ..., b, a; check each
    result; return name -> [ms, ms]."""
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        ms, got = cs.timed_ms(lambda: fn(name), device, reps=reps, warmup=1, hold=hold)
        want_check(name, got)
        times[name].append(ms)
        del got
    return times


def fused_inputs(device: torch.device) -> dict:
    """name -> (data, queries, plain buffers) of the two fused kernels at the
    SIFT per-segment shape: random signs of 238 bits, queries data rows with 5
    % of their signs flipped (packed_cosine_topk); random minhash ids in [0,
    254), 238 a row, queries data rows with 10 % of their ids redrawn
    (packed_tanimoto_topk)."""
    from repro_torch.core import packing
    from repro_torch.kernels.packed_cosine import packed_cosine_topk_plain
    from repro_torch.kernels.packed_tanimoto import packed_tanimoto_topk_plain

    gen = torch.Generator(device=device).manual_seed(cs.SEED + 12)
    pick = torch.arange(Q, device=device) * 271 % N_SIFT
    sg = torch.randint(0, 2, (N_SIFT, V_SIFT), generator=gen, device=device,
                       dtype=torch.int8) * 2 - 1
    qs = sg[pick].clone()
    qs[torch.rand(qs.shape, generator=gen, device=device) < 0.05] *= -1
    dw, qw = packing.pack_signs_data(sg), packing.pack_signs_queries(qs)
    ids = torch.randint(0, 254, (N_SIFT, V_SIFT), generator=gen, device=device,
                        dtype=torch.int32)
    qi = ids[pick].clone()
    redraw = torch.rand(qi.shape, generator=gen, device=device) < 0.1
    qi[redraw] = torch.randint(0, 254, (int(redraw.sum()),), generator=gen, device=device,
                               dtype=torch.int32)
    du, qu = packing.pack_buckets(ids), packing.pack_buckets(qi)
    return {"packed_cosine_topk": (dw, qw, packed_cosine_topk_plain(dw, qw, K)),
            "packed_tanimoto_topk": (du, qu, packed_tanimoto_topk_plain(du, qu, K))}


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--sass-dir=")]
    sass_dir = next((Path(a.split("=", 1)[1]) for a in sys.argv[1:]
                     if a.startswith("--sass-dir=")), None)
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__ if len(args) > 1 else "needs one CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.cpq_hist import cpq_hist_plain

    device = torch.device("cuda", 0)
    checkouts = {"this": ROOT / "src/repro_torch/kernels/csrc"}
    if args:
        checkouts = {"other": Path(args[0]).resolve() / "src/repro_torch/kernels/csrc",
                     **checkouts}
    specs = [v for label, csrc in checkouts.items() for v in variants(label, csrc)]
    built = build_all(specs)
    zeros = {name: hist_needs_zeros(csrc) for name, csrc in specs}
    for name, (lib, text) in built.items():
        emit(library=name, ptxas={k: ptxas_of(text, k) for k in ("topk_kernel", "cpq_hist")},
             sass=sass_summary(lib))
        if sass_dir:
            sass_dir.mkdir(parents=True, exist_ok=True)
            for fn, body in build.sass(lib).items():
                if "topk_kernel" in fn or "cpq_hist" in fn:
                    tag = "cosine" if "cosine" in fn else "tanimoto" if "tanimoto" in fn else "hist"
                    wide = "u16" if "FusedIt" in fn else "u8" if "FusedIh" in fn else ""
                    out = sass_dir / f"{re.sub(r'[^0-9A-Za-z]+', '_', name)}_{tag}{wide}.sass"
                    out.write_text(f"{fn}\n{body}")
    libs = {name: Lib(lib) for name, (lib, _) in built.items()}

    names = list(libs)
    for kernel, (d, s, want) in fused_inputs(device).items():
        def check_topk(name, got):
            if "," not in name or "two-byte" in name:
                cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                         f"{name}: {kernel} differs from its plain version")

        times = in_turns(names, lambda name: libs[name].topk(kernel, d, s, K), check_topk,
                         device, reps=5, hold=False)
        clocks = {name: cs.sm_clock_mhz(lambda: libs[name].topk(kernel, d, s, K), device)
                  for name in names}
        emit(kernel=kernel, Q=Q, N=N_SIFT, width=d.shape[1], k=K, ms=times,
             sm_clock_mhz=clocks)
        del d, s, want
        torch.cuda.empty_cache()

    hist_names = [n for n in names if "," not in n]
    for label, counts, nbins in path_counts(device):
        want_h = cpq_hist_plain(counts, nbins - 1)
        share = (want_h.sum(dim=0).double() / want_h.sum()).tolist()
        top = sorted(range(nbins), key=lambda b: -share[b])[:4]

        def check_hist(name, got):
            cs.check(torch.equal(got, want_h), f"{name}: cpq_hist differs ({label})")

        times = in_turns(hist_names, lambda name: libs[name].hist(counts, nbins, zeros[name]),
                         check_hist, device, reps=10, hold=True)
        clocks = {name: cs.sm_clock_mhz(lambda: libs[name].hist(counts, nbins, zeros[name]),
                                        device) for name in hist_names}
        q, n = counts.shape
        emit(kernel="cpq_hist", path=label, Q=q, N=n, bins=nbins,
             largest_bins={b: round(share[b], 4) for b in top}, ms=times, sm_clock_mhz=clocks,
             bytes_bound_ms=(q * n + q * nbins) * 4 / cs.PEAK_BYTES_PER_S * 1e3)
        del counts, want_h
        torch.cuda.empty_cache()
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
