"""GENIE (generic inverted-index similarity search) on PyTorch + CUDA.

The port of the JAX package `repro`, module for module
(`repro_torch/core/plan.py` is the counterpart of `repro/core/plan.py`).
It imports torch, never jax, and nothing of `repro`.

Device rule: every entry point takes `device`; `None` means "cuda", and when
no CUDA device is present that raises -- nothing carries on on the CPU unless
the caller passes `device="cpu"`, which selects the plain PyTorch version of
each kernel (the tests do).
"""
