# Serving: the LM serving engine, the GENIE retrieval service and the
# multi-tenant front-end.
from repro_torch.serve.engine import ServeEngine, ServeStats  # noqa: F401
from repro_torch.serve.frontend import IndexService, ServingFrontend  # noqa: F401
from repro_torch.serve.metrics import FrontendMetrics  # noqa: F401
from repro_torch.serve.retrieval import RetrievalService  # noqa: F401
from repro_torch.serve.scheduler import Overloaded, Request, RequestQueue  # noqa: F401
