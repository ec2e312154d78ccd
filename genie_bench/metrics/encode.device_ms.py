"""encode.device_ms: device milliseconds a request of the queries' encoding
from word ids into binary word vectors (`encode`, under the root
`document.search`): the sum of the `device_ms` of those spans of the
program (`repro_torch.trace`) over the window's searches.  Nothing where
the program keeps no such spans or times none on the device."""
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
    ms = [s["device_ms"] for s in spans.named(got[0], "encode")]
    if not ms or None in ms:
        return None
    return sum(ms) / ctx.requests
