"""cpq.candidates_per_k: the objects the c-PQ gate lets through (its counter
`cpq.passed`, the objects at or above the threshold, in the program's
spans, `repro_torch.trace`) per slot the parts keep (each `part` span's
query rows times the width of its buffer, min(k, rows)), over the window's
searches: how many candidates the compaction, which scans every count,
finds for each one it keeps.  Nothing where the program keeps no spans or
counts nothing."""
import importlib.util
from pathlib import Path

_SPEC = importlib.util.spec_from_file_location(
    "genie_bench_program_spans", Path(__file__).with_name("search.idle_ms.py"))
spans = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(spans)


def read(ctx):
    got = spans.joined(ctx)
    if got is None:
        return None
    passed = [s["counters"]["cpq.passed"] for s in spans.named(got[0], "cpq.gate")
              if "cpq.passed" in s["counters"]]
    slots = sum(p["attrs"]["queries"] * p["attrs"]["k"] for p in spans.named(got[0], "part"))
    if not passed or slots <= 0:
        return None
    return sum(passed) / slots
