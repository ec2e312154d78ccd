"""The front-end's knee on the sift-e2lsh deployment: the open loop
(`loops/open.py`) of single queries at fixed rates through `ServingFrontend`,
to find the highest rate it sustains (no request shed, no growing backlog).
Not a cell: it finds the rate at which a later open-loop cell is set.

    python3 genie_bench/tools/frontend_knee.py --rates 500 1000 2000 --seconds 20 [--repeat 1]

Requests of one row, k = 10, arrive as a Poisson process drawn from the seed
(`--seed`; each window its own arrivals), each timed from when it was due to
when its answer was back; the front-end at its defaults (max_batch 1024,
max_wait_us 2000, max_queue 256).  One JSON line a window: requests sent,
shed, answered, never answered within `--drain` seconds past the window,
and the open loop's readings (latency percentiles, how late the generator
ran, the first and last quarters' medians, rows a dispatch)."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from genie_bench.harness import cell as cell_lib, traffic  # noqa: E402
from genie_bench.harness.program import ROOT, SRC  # noqa: E402
from genie_bench.loops import open as open_loop  # noqa: E402

sys.path.insert(0, str(SRC))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--drain", type=float, default=30.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("frontend_knee: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cell_lib.load(ROOT, "sift-e2lsh.batch1024")
    cfg, ref = dict(cell.cfg, k=10), cell.reference()
    inp = ref.inputs(cfg, args.seed, device)
    system = cell.system().System(cfg, args.seed, ref, inp, device)
    stream = traffic.QueryStream(ref, cfg, args.seed, inp, system, device)
    run = traffic.Run(system, stream, device, args.seed)
    mix = {"loop": "open", "rate": args.rates[0], "batch": 1, "max_batch": 1024,
           "max_wait_us": 2000, "max_queue": 256, "trace_requests": 1, "drain_s": args.drain}
    loop = open_loop.Loop(mix)
    try:
        loop.warm(run)
        torch.cuda.synchronize(device)
        for rate in args.rates:
            mix["rate"] = rate
            for rep in range(args.repeat):
                stream.make(loop.requests_expected(args.seconds, 0.0) * mix["batch"])
                win = loop.window(run, seconds=args.seconds)
                out = {"rate": rate, "repeat": rep, "seconds": args.seconds,
                       "sent": win.queries, "shed": win.failed, "answered": len(win.answers),
                       "never_answered": win.missing, **win.readings,
                       "device": torch.cuda.get_device_name(device)}
                print(json.dumps(out), flush=True)
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
