"""What the benchmark takes from the program under test besides the system
itself: where it lives, the names of its own CUDA kernels, and the check
that no module of the JAX package it was ported from is loaded."""
from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"
PACKAGE = "repro_torch"
CSRC = SRC / PACKAGE / "kernels" / "csrc"
# top-level module names a run must not load: JAX, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def present() -> bool:
    return (SRC / PACKAGE / "__init__.py").is_file()


def own_kernel_names() -> list:
    """The `__global__` functions of the program's CUDA sources."""
    return sorted({n for f in CSRC.glob("*.cu") for n in _GLOBAL.findall(f.read_text())})


def own_kernels() -> re.Pattern:
    names = own_kernel_names()
    if not names:
        raise RuntimeError(f"no CUDA kernel found under {CSRC}")
    return re.compile(r"\b(?:" + "|".join(names) + r")\b")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port `repro_torch` begins with `repro`)."""
    return sorted({name for name in (sys.modules if modules is None else modules)
                   if name.split(".")[0] in FORBIDDEN})
