#!/usr/bin/env python3
"""Measure how many of a few SASS instructions an SM issues per clock on one
CUDA card: the instructions of the float16 count loops (the equality tile of
src/repro_torch/kernels/csrc/eq_tile.cuh, range_count.cu's interval test).

    python3 tools/fp16_pipe_rates.py

Builds a small kernel per instruction (inline PTX, 8 independent chains a
thread, 64 warps an SM) with nvcc into src/repro_torch/kernels/_build/ and
times each with CUDA events.  Prints, per instruction, the thread-instructions
per SM per clock at the SM clock that nvidia-smi reads while the kernels run,
then the card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (name, PTX on the chain register %0 and the operand %1, PTX instructions)
OPS = [
    ("HSET2 (set.eq.f16x2)", "set.eq.f16x2.f16x2 %0, %0, %1;", 1),
    ("HADD2 (add.rn.f16x2)", "add.rn.f16x2 %0, %0, %1;", 1),
    ("HFMA2 (fma.rn.f16x2)", "fma.rn.f16x2 %0, %0, %1, %1;", 1),
    ("HSET2 + HADD2, the fast path's pair",
     "{.reg .b32 t; set.eq.f16x2.f16x2 t, %0, %1; add.rn.f16x2 %0, %0, t;}", 2),
    ("FADD (add.rn.f32)", "add.rn.f32 %0, %0, %1;", 1),
    ("HADD2.SAT (add.rn.sat.f16x2)", "add.rn.sat.f16x2 %0, %0, %1;", 1),
    ("HFMA2.SAT (fma.rn.sat.f16x2)", "fma.rn.sat.f16x2 %0, %0, %1, %1;", 1),
    ("HMNMX2 (min.f16x2)", "min.f16x2 %0, %0, %1;", 1),
    ("range_count's test: two saturated adds and an fma",
     "{.reg .b32 a, b; add.rn.sat.f16x2 a, %0, %1; sub.rn.sat.f16x2 b, %1, %0; "
     "fma.rn.f16x2 %0, a, b, %0;}", 3),
    ("the test as two HSET2.LE and an fma",
     "{.reg .b32 a, b; set.le.f16x2.f16x2 a, %0, %1; set.le.f16x2.f16x2 b, %1, %0; "
     "fma.rn.f16x2 %0, a, b, %0;}", 3),
]
CHAINS, ITERS, BLOCKS_PER_SM, THREADS = 8, 20000, 8, 256

SOURCE = r"""
#include <cuda_runtime.h>
template <int OP>
__global__ void __launch_bounds__(256) chain(unsigned* out, unsigned x, unsigned y, int iters) {
  unsigned r[%(chains)d];
  for (int c = 0; c < %(chains)d; ++c) r[c] = x + threadIdx.x * 17 + c;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < %(chains)d; ++c) {
%(bodies)s
    }
  }
  unsigned s = 0;
  for (int c = 0; c < %(chains)d; ++c) s ^= r[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int op, unsigned* out, int blocks, int iters, unsigned x, unsigned y) {
  switch (op) {
%(cases)s
  }
  return (int)cudaGetLastError();
}
"""


def source() -> str:
    def operands(ptx: str) -> str:
        if ".f32" in ptx:                  # float32 registers
            return '"+f"(reinterpret_cast<float&>(r[c])) : "f"(__uint_as_float(y))'
        return '"+r"(r[c]) : "r"(y)'
    bodies = "\n".join(f'      if (OP == {i}) asm volatile("{ptx}" : {operands(ptx)});'
                       for i, (_, ptx, _) in enumerate(OPS))
    cases = "\n".join(f"    case {i}: chain<{i}><<<blocks, 256>>>(out, x, y, iters); break;"
                      for i in range(len(OPS)))
    return SOURCE % {"chains": CHAINS, "bodies": bodies, "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    work = build.BUILD_DIR / "fp16_pipe_rates"
    work.mkdir(parents=True, exist_ok=True)
    (work / "rates.cu").write_text(source())
    lib_path = work / "librates.so"
    subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(work / "rates.cu")],
                   check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                        ctypes.c_uint]
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=device)
    x, y = 0x3C003C00, 0x3C013C00
    for i, (name, _, per_step) in enumerate(OPS):
        def launch(iters=ITERS):
            status = lib.run(i, out.data_ptr(), blocks, iters, x, y)
            cs.check(status == 0, f"{name}: launch failed with error {status}")
        ms, _ = cs.timed_ms(launch, device, reps=3, warmup=1)
        clock = cs.sm_clock_mhz(launch, device, seconds=2.0)
        count = blocks * THREADS * ITERS * CHAINS * per_step
        rate = count / (ms * 1e-3) / sms / (clock * 1e6) if clock else None
        print(f"{name}: {ms:.4f} ms for {count:.4g} PTX instructions; SM clock {clock} MHz; "
              f"{rate} thread-instructions per SM-clock", flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
