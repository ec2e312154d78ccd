"""Shotgun-and-Assembly search (paper section V): the preprocessing that
makes the MINSUM, IP and RANGE engines' inputs (`ngram`, `relational`: numpy
on the host, copies of the JAX package's modules, which import no jax;
`document`: the same on the host, and on the device the word-id encoder and
`DocumentIndex`, the IP engine's entry for short documents) and the
verification of sequence candidates (`verify`, in PyTorch)."""
from repro_torch.core.sa import document, ngram, relational, verify  # noqa: F401
from repro_torch.core.sa.document import DocumentIndex  # noqa: F401
