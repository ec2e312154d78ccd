"""Build and load the hand-written CUDA kernels (no counterpart in the JAX
package: XLA compiled the Pallas kernels there).

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into an object file --
one compiler process per source, all started together -- and the objects are
linked into one shared library with a plain C interface, which `ctypes`
loads.  The sources include no PyTorch header, so a build takes seconds.
Nothing is built at import: `load()` builds at first use, from the sources in
this package and nothing else, into `_build/` beside this file (git-ignored).
The library's name carries a hash of the sources, the headers they include
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt and a
finished build is reused.  A failed build raises; no
caller falls back to another path.

Pointers and the stream cross the C boundary as `c_void_p`: without
`argtypes` ctypes would pass a Python int as a 32-bit C int and cut the
pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
_BUILD_SECONDS: Optional[float] = None


def sources() -> list[Path]:
    """The translation units, one compiler process each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include: hashed with them, not compiled."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda): the CUDA kernels are built at first use and "
        "cannot be built on this machine"
    )


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*srcs, *headers()]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands: list[list[str]], log: Path) -> None:
    """Start every command at once, wait for all, raise on the first failure.
    The compilers' output (ptxas -v: registers, shared memory, spills) is
    appended to `log`."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [p.communicate()[0] for p in procs]
    with open(log, "a", encoding="utf-8") as f:
        for cmd, out in zip(commands, outputs):
            f.write("$ " + " ".join(cmd) + "\n" + out + "\n")
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{out}"
            )


def build() -> Path:
    """Compile and link the kernel library if this source state has not been
    built yet; return the library's path."""
    global _BUILD_SECONDS
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    tag = _digest(srcs)
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = BUILD_DIR / f"build_{tag}.log"
    log.write_text("")
    # per-process names: two processes may build the same state at once, and
    # the finished library is moved into place atomically
    stem = f"{tag}_{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}_{stem}.o" for src in srcs]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(srcs, objects)], log)
    tmp_lib = BUILD_DIR / f"lib_{stem}.so.tmp"
    _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
               *map(str, objects)]], log)
    os.replace(tmp_lib, lib_path)
    for obj in objects:
        obj.unlink()
    _BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def build_seconds() -> Optional[float]:
    """Seconds this process spent building, None if it found a finished
    build (or has not loaded the library yet)."""
    return _BUILD_SECONDS


def build_log() -> str:
    """The compilers' output for the current source state ('' when the
    library has not been built)."""
    log = BUILD_DIR / f"build_{_digest(sources())}.log"
    return log.read_text(encoding="utf-8") if log.exists() else ""


def sass(lib_path: Optional[Path] = None) -> dict[str, str]:
    """The SASS of every kernel in the library (`cuobjdump -sass`, from the
    toolkit that holds nvcc), by mangled function name; `lib_path` defaults
    to this source state's build."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path or build())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out: dict[str, str] = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # int repro_match_count(data, query, out, n_data, n_query, m, stream),
        # and repro_match_count_q32 (32 query rows a block) alike
        lib.repro_match_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_match_count.restype = i32
        lib.repro_match_count_q32.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_match_count_q32.restype = i32
        # int repro_cpq_hist(counts, hist, n, n_query, nbins, stream)
        lib.repro_cpq_hist.argtypes = [ptr, ptr, i64, i32, i32, ptr]
        lib.repro_cpq_hist.restype = i32
        # int repro_cpq_compact_plan(n, n_query, cap, *n_chunks, *scratch_ints)
        lib.repro_cpq_compact_plan.argtypes = [
            i64, i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.repro_cpq_compact_plan.restype = i32
        # int repro_cpq_compact(counts, threshold, ids, vals, scratch, n, n_query, cap, stream)
        lib.repro_cpq_compact.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_cpq_compact.restype = i32
        # int repro_cosine_count(data, query, out, n_data, n_query, v, stream)
        lib.repro_cosine_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_cosine_count.restype = i32
        # int repro_cosine_count_loader(data, query, v): 1 TMA, 0 registers
        lib.repro_cosine_count_loader.argtypes = [ptr, ptr, i32]
        lib.repro_cosine_count_loader.restype = i32
        # int repro_packed_cosine_count(data, query, out, n_data, n_query, w, stream)
        lib.repro_packed_cosine_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_packed_cosine_count.restype = i32
        # int repro_packed_cosine_topk_plan(n_data, n_query, w, *grid, *scratch_ints)
        lib.repro_packed_cosine_topk_plan.argtypes = [
            i64, i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.repro_packed_cosine_topk_plan.restype = i32
        # int repro_packed_cosine_topk(data, query, ids, counts, n_data, n_query,
        #                              w, kc, grid, scratch, stream)
        lib.repro_packed_cosine_topk.argtypes = [
            ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr]
        lib.repro_packed_cosine_topk.restype = i32
        # the same two for tiles of 1024 data rows
        lib.repro_packed_cosine_topk_n1024_plan.argtypes = (
            lib.repro_packed_cosine_topk_plan.argtypes)
        lib.repro_packed_cosine_topk_n1024_plan.restype = i32
        lib.repro_packed_cosine_topk_n1024.argtypes = lib.repro_packed_cosine_topk.argtypes
        lib.repro_packed_cosine_topk_n1024.restype = i32
        # int repro_tanimoto_count(data, query, out, n_data, n_query, m, stream),
        # and repro_tanimoto_count_q32 (32 query rows a block) alike
        lib.repro_tanimoto_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_tanimoto_count.restype = i32
        lib.repro_tanimoto_count_q32.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_tanimoto_count_q32.restype = i32
        # int repro_packed_tanimoto_count(data, query, out, n_data, n_query, m, stream)
        lib.repro_packed_tanimoto_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_packed_tanimoto_count.restype = i32
        # int repro_packed_tanimoto_topk_plan(n_data, n_query, m, *grid, *scratch_ints)
        lib.repro_packed_tanimoto_topk_plan.argtypes = [
            i64, i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.repro_packed_tanimoto_topk_plan.restype = i32
        # int repro_packed_tanimoto_topk(data, query, ids, counts, n_data, n_query,
        #                                m, kc, grid, scratch, stream)
        lib.repro_packed_tanimoto_topk.argtypes = [
            ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr]
        lib.repro_packed_tanimoto_topk.restype = i32
        # the same two for tiles of 1024 data rows
        lib.repro_packed_tanimoto_topk_n1024_plan.argtypes = (
            lib.repro_packed_tanimoto_topk_plan.argtypes)
        lib.repro_packed_tanimoto_topk_n1024_plan.restype = i32
        lib.repro_packed_tanimoto_topk_n1024.argtypes = lib.repro_packed_tanimoto_topk.argtypes
        lib.repro_packed_tanimoto_topk_n1024.restype = i32
        # int repro_range_count(data, lo, hi, out, n_data, n_query, d, stream)
        lib.repro_range_count.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_range_count.restype = i32
        # int repro_minsum_nnz(data, nnz, n_data, v, stream)
        lib.repro_minsum_nnz.argtypes = [ptr, ptr, i64, i32, ptr]
        lib.repro_minsum_nnz.restype = i32
        # int repro_minsum_csr(data, offsets, entries, n_data, v, stream)
        lib.repro_minsum_csr.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
        lib.repro_minsum_csr.restype = i32
        # int repro_minsum_count_row_limit(*limit)
        lib.repro_minsum_count_row_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.repro_minsum_count_row_limit.restype = i32
        # int repro_minsum_count(entries, offsets, q_entries, q_offsets, out, n_data,
        #                        n_query, v, widest, stream)
        lib.repro_minsum_count.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr]
        lib.repro_minsum_count.restype = i32
        # int repro_minsum_count_dense(data, query, out, n_data, n_query, v, stream)
        lib.repro_minsum_count_dense.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_minsum_count_dense.restype = i32
        # int repro_ip_count(data, query, out, n_data, n_query, v, stream)
        lib.repro_ip_count.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_ip_count.restype = i32
        # int repro_ip_count_loader(data, query, v): 1 TMA, 0 registers
        lib.repro_ip_count_loader.argtypes = [ptr, ptr, i32]
        lib.repro_ip_count_loader.restype = i32
        _LIB = lib
    return _LIB
