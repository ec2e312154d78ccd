# Serving: the GENIE retrieval service (the LM serving engine and the
# multi-tenant front-end of the JAX package are still to be ported).
from repro_torch.serve.retrieval import RetrievalService  # noqa: F401
