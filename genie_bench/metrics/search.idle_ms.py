"""search.idle_ms: device idle milliseconds a request inside the program's
searches: the gaps between device operations (`ctx.trace.busy_intervals()`)
that lie inside a root span of the program (`repro_torch.trace`), whose
host interval the profiler's trace holds on the same clock.  This is the
idle the program causes; the rest of the window's idle is the benchmark's
loop and the answers' copies.

Also what every reader of the program's spans shares: `joined(ctx)`, the
window's searches as `repro_torch.trace.searches()` gives them beside their
root spans in the trace, or None where the program keeps no spans or the
two do not pair up one for one, by name and in order; `named(found, name)`,
every span of that name in them."""

PREFIX = "repro_torch."


def trace_roots(tr) -> list:
    """The program's spans in the trace's window that no other of its spans
    contains, in order."""
    spans = sorted((o for o in tr.host if o.cat == "user_annotation"
                    and o.name.startswith(PREFIX) and tr.start <= o.start and o.end <= tr.end),
                   key=lambda o: (o.start, -o.end))
    roots = []
    for o in spans:
        if not any(r.start <= o.start and o.end <= r.end for r in roots):
            roots.append(o)
    return roots


def joined(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    if ctx.requests < 1:
        return None
    found = trace.searches(ctx.requests)
    roots = trace_roots(ctx.trace)
    if len(found) != ctx.requests or [PREFIX + s["name"] for s in found] != [r.name for r in roots]:
        return None
    return found, roots


def named(found: list, name: str) -> list:
    out, todo = [], list(found)
    while todo:
        s = todo.pop()
        out += [s] if s["name"] == name else []
        todo += s["children"]
    return out


def read(ctx):
    got = joined(ctx)
    if got is None:
        return None
    tr, t, gaps = ctx.trace, ctx.trace.start, []
    for s, e in tr.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.end > t:
        gaps.append((t, tr.end))
    idle = sum(max(0.0, min(e, r.end) - max(s, r.start)) for s, e in gaps for r in got[1])
    return 1e3 * idle / ctx.requests
