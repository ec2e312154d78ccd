#!/usr/bin/env python3
"""Compare the equality count kernels of this checkout with another one, on
one CUDA card.

    python3 tools/eq_tile_ab.py OTHER_DIR

OTHER_DIR holds an unpacked checkout of another commit (`git archive`).  Both
kernel libraries are built from their own sources
(`src/repro_torch/kernels/csrc`) and loaded side by side with ctypes; then
`repro_match_count` of each is

  - disassembled: the count bodies' instructions per compared (query, data,
    column) pair, by opcode and pipe (`chip_smoke.sass_count_bodies`), with
    what ptxas reported for the kernel;
  - timed in turns (other, this, this, other) at the SIFT per-segment shape
    (Q = 1024, N = 281,250, m = 238) on bucket ids in [0, 8192) and on
    full-range int32 ids, and at Q = 1024, N = 16,384, m = 4096 on ids in
    [0, 254), with the SM clock while each runs;
  - held against the other library's result and the plain version, bit for
    bit.

Prints one JSON line per measurement and the card's name and power limit.
Needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (label, N, m, low, high): ids drawn from [low, high)
CASES = [("bucket ids [0, 8192)", 281_250, 238, 0, 8192),
         ("full-range int32", 281_250, 238, -2**31, 2**31 - 1),
         ("m = 4096, ids [0, 254)", 16_384, 4096, 0, 254)]
Q = 1024


def build_other(other: Path) -> Path:
    """Build the other checkout's library in a process of its own (two
    packages named repro_torch cannot share one) and return its path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; print(build.build())")
    out = subprocess.run([sys.executable, "-c", code, str(other / "src")], check=True,
                         capture_output=True, text=True, timeout=900)
    return Path(out.stdout.strip().splitlines()[-1])


def match_count_entry(lib_path: Path):
    """repro_match_count of the library at `lib_path` as a function of two
    contiguous int32 CUDA tensors."""
    fn = ctypes.CDLL(str(lib_path)).repro_match_count
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        out = torch.empty((s.shape[0], d.shape[0]), dtype=torch.int32, device=d.device)
        status = fn(d.data_ptr(), s.data_ptr(), out.data_ptr(), d.shape[0], s.shape[0],
                    d.shape[1], torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{lib_path.name}: launch failed with error {status}")
        return out
    return call


def ptxas_lines(lib_path: Path, kernel: str) -> list:
    """What ptxas reported for `kernel` in the build log beside the library."""
    tag = lib_path.stem.rsplit("_", 1)[-1]
    log = lib_path.with_name(f"build_{tag}.log")
    lines, keep = [], False
    for line in log.read_text(encoding="utf-8").splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            keep = f"{len(kernel)}{kernel}" in line
        if keep and ("registers" in line or "spill" in line or "Compiling" in line):
            lines.append(line.strip())
    return lines


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "needs one CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.match_count import match_count_plain

    device = torch.device("cuda", 0)
    libs = {"other": build_other(Path(sys.argv[1]).resolve()), "this": build.build()}
    for side, path in libs.items():
        bodies = cs.sass_count_bodies(build.sass(path), "match_count_kernel")
        print(json.dumps({"side": side, "library": path.name,
                          "ptxas": ptxas_lines(path, "match_count_kernel"),
                          "sass_bodies": bodies}), flush=True)
    kernels = {side: match_count_entry(path) for side, path in libs.items()}
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 11)
    for label, n, m, low, high in CASES:
        d = torch.randint(low, high, (n, m), generator=gen, device=device, dtype=torch.int32)
        s = torch.randint(low, high, (Q, m), generator=gen, device=device, dtype=torch.int32)
        s[::2] = d[torch.arange(0, Q, 2, device=device) * 997 % n]
        want = match_count_plain(d, s)
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            ms, got = cs.timed_ms(lambda: kernels[side](d, s), device, reps=5, warmup=1)
            cs.check(torch.equal(got, want), f"{side} differs from the plain version ({label})")
            times[side].append(ms)
            del got
        del want
        clocks = {side: cs.sm_clock_mhz(lambda: kernels[side](d, s), device)
                  for side in ("other", "this")}
        print(json.dumps({"case": label, "Q": Q, "N": n, "m": m, "ms": times,
                          "sm_clock_mhz": clocks,
                          "pairs_per_sm_clock": {
                              side: cs.pairs_per_sm_clock(Q * n * m, min(times[side]),
                                                          clocks[side])
                              for side in times}}), flush=True)
        del d, s
        torch.cuda.empty_cache()
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
