"""Shotgun-and-Assembly search (paper section V): the host preprocessing that
makes the MINSUM, IP and RANGE engines' inputs (`ngram`, `document`,
`relational`: numpy, copies of the JAX package's modules, which import no
jax) and the verification of sequence candidates (`verify`, in PyTorch)."""
from repro_torch.core.sa import document, ngram, relational, verify  # noqa: F401
