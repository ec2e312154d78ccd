"""Run one cell of the benchmark once, on the CUDA device it is started on.

    python3 genie_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's deployment from the seed (inputs on the device, the
corpus added to the program), warms the cell's request shapes up under its
loop and makes the query rows the window will send; then either
`--seconds` of requests under the cell's traffic (`--trace 0`: the
end-to-end metrics, as the loop reads them by name, with `peak_device_gb`
and `setup_s`) or a few profiled requests (`--trace 1`: the per-layer
metrics).  Once the window has closed and the
program is freed, the plain reference checks the answers.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, end standard error and the line.  Exits non-zero, with no result,
where there is no CUDA device, too few of them, no program, or a module of
JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from genie_bench.harness import program  # noqa: E402

sys.path.insert(0, str(program.SRC))

import torch  # noqa: E402

from genie_bench.harness import cell as cell_lib  # noqa: E402
from genie_bench.harness import trace as trace_lib  # noqa: E402
from genie_bench.harness import traffic  # noqa: E402
from genie_bench.harness.peaks import Context  # noqa: E402
from genie_bench.harness.seeds import generator  # noqa: E402
from genie_bench.reference.topk import malformed_rows  # noqa: E402


class _Stages:
    """Seconds of each stage of a run since the last, on the host clock
    after the device has finished; calling it returns the seconds since
    `t_start`."""

    def __init__(self, t_start: float, device):
        self.t_start = self.last = t_start
        self.device = device
        self.seconds = {}

    def __call__(self, name: str) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        return now - self.t_start


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _sample(cfg: dict, seed: int, answers: list) -> dict:
    """A seeded sample of `check_queries` answered queries, all requests
    alike, as the reference checks them."""
    cat = {k: torch.cat([a[k] for a in answers]) for k in ("rows", "ids", "counts", "threshold")}
    if answers[0]["sims"] is not None:
        cat["sims"] = torch.cat([a["sims"] for a in answers])
    total = cat["rows"].shape[0]
    pick = torch.randperm(total, generator=generator(seed, "check", device="cpu"))
    pick = pick[:min(total, cfg["check_queries"])]
    return {k: v[pick] for k, v in cat.items()}


def _malformed(cfg: dict, answers: list) -> int:
    return sum(malformed_rows(a["ids"].numpy(), a["counts"].numpy(), a["threshold"].numpy(),
                              cfg["n_objects"]) for a in answers)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def end_to_end(cell, readings: dict) -> dict:
    """The cell's end-to-end metrics, each from the run's reading of its name."""
    missing = [m["name"] for m in cell.end_to_end if readings.get(m["name"]) is None]
    if missing:
        raise KeyError(f"{cell.name}: the run took no reading of {missing}; it took "
                       f"{sorted(k for k, v in readings.items() if v is not None)}")
    return {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell`; returns the result line as a dict."""
    cfg, mix = cell.cfg, cell.mix
    stages = _Stages(t_start, device)
    stages("imports and CUDA context")
    ref = cell.reference()
    inp = ref.inputs(cfg, seed, device)
    stages("inputs")
    system = cell.system().System(cfg, seed, ref, inp, device)
    stream = traffic.QueryStream(ref, cfg, seed, inp, system, device)
    run = traffic.Run(system, stream, device, seed,
                      trace_lib.request_span if trace else contextlib.nullcontext)
    loop = cell.loop()
    stages("program and corpus")
    try:
        request_s = loop.warm(run)
        stages("warm-up")
        requests = (mix["trace_requests"] + 1 if trace
                    else loop.requests_expected(seconds, request_s))
        stream.make(requests * mix["batch"])
        setup_s = stages("queries")
        setup_peak = _peak(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            traced, window = trace_lib.profile(
                lambda: loop.window(run, requests=1),
                lambda: loop.window(run, requests=mix["trace_requests"]))
        else:
            window = loop.window(run, seconds=seconds)
        window_peak = _peak(device)
    finally:
        loop.close()
    late = stream.blocks_made_late
    system.close()
    del system, run, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stages("window")

    answers = window.answers
    if not answers:
        raise RuntimeError(f"{cell.name}: no request of the window was answered")
    malformed = _malformed(cfg, answers)
    sample = _sample(cfg, seed, answers)
    work = [stream.raw_rows(a["rows"]) for a in answers] if trace else None
    judged = ref.evaluate(cfg, seed, inp, stream.raw_rows(sample["rows"]), sample, work, device)
    stages("reference")
    limits = cfg["limits"]
    checks = {"answer_faults": judged["answer_faults"] + malformed + window.missing}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak),
           "power_limit": power_limit() if device.type == "cuda" else None}
    result = {"correct": all(checks[k] <= limits[k] for k in checks),
              "attempted": window.queries,
              "failed": malformed + (window.failed + window.missing) * mix["batch"]}
    if trace:
        ctx = Context(cfg=cfg, trace=traced, requests=len(answers),
                      least_work=judged["least_work"], own_kernels=program.own_kernels(),
                      readings=window.readings)
        metrics = {}
        for m in cell.per_layer:
            value = cell_lib.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result.update(metrics=metrics, device=dev, breakdown=traced.breakdown())
    else:
        readings = dict(window.readings, peak_device_gb=window_peak / 1e9, setup_s=setup_s)
        result.update(metrics=end_to_end(cell, readings), device=dev)
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    for name, secs in stages.seconds.items():
        print(f"stage {name} {secs:.3f} s", file=sys.stderr)
    if late:
        print(f"query blocks made inside the window: {late}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    cell = cell_lib.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"genie_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not program.present():
        print(f"genie_bench: the program {program.PACKAGE} is not under {program.SRC}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = program.forbidden_modules()
    if found:
        print(f"genie_bench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
