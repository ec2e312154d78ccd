# Hand-written CUDA kernels for the compute hot spots (EQ match-count, c-PQ
# histogram), their wrappers and plain PyTorch versions (ref.py re-exports the
# oracles).  Built at first use by build.py; nothing here compiles at import.
