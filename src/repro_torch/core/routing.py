"""Routing modes of a planned search.

Only the mode names are ported: they are an axis of `plan.batch_compat_key`
and of `QueryPlan.describe()`.  The router itself (segment summaries, upper
bounds, `routed` / `routed_verified` execution; `repro/core/routing.py`) is
still to be ported (ROADMAP queue 1 item 6), so every plan of the port runs
with `Routing.NONE` and anything else raises NotImplementedError.
"""
from __future__ import annotations

import enum


class Routing(str, enum.Enum):
    """Routing mode of a planned search."""

    NONE = "none"                        # full scan, bit-exact
    ROUTED = "routed"                    # prune, approximate
    ROUTED_VERIFIED = "routed_verified"  # prune + threshold-verify + fallback


def require_none(routing: "Routing | str") -> Routing:
    """Validate a routing mode and refuse the ones not ported yet."""
    routing = Routing(routing)
    if routing is not Routing.NONE:
        raise NotImplementedError(
            f"routing={routing.value!r} is not ported yet (ROADMAP queue 1 "
            f"item 6: core/routing.py and the routed executors); use "
            f"routing='none'"
        )
    return routing
