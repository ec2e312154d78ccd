# The paper's primary contribution: GENIE generic inverted-index similarity
# search (match-count model, c-PQ selection, LSH transforms, segment and
# distributed merge).
# Engine dispatch lives in the MatchModel registry (core/engines.py); query
# execution is the unified plan->execute pipeline (core/plan.py): every
# search path builds a QueryPlan and delegates to the one executor that calls
# match kernels, pad masks, select_topk, and the merge buffers.
from repro_torch.core import (  # noqa: F401
    autotune, cpq, distributed, engines, index, match, merge, multiload, plan, postings, routing,
    segments, select, spq,
)
from repro_torch.core.engines import MatchModel  # noqa: F401
from repro_torch.core.index import GenieIndex  # noqa: F401
from repro_torch.core.multiload import multiload_search, multiload_search_host  # noqa: F401
from repro_torch.core.plan import Layout, QueryPlan, execute, plan_search  # noqa: F401
from repro_torch.core.routing import Routing  # noqa: F401
from repro_torch.core.segments import SegmentedIndex  # noqa: F401
from repro_torch.core.select import select_topk  # noqa: F401
from repro_torch.core.types import Engine, SearchParams, TopKMethod, TopKResult  # noqa: F401
