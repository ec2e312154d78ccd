"""The control's readings at a cell's own size, on the card it runs on:

    python3 genie_bench/tools/control_readings.py --workload <cell> --seeds 1 2 3

Prints one JSON line: the cell, the seeds, and `answer_faults` of the
control on each (harness/control.py).  The benchmark's runs never run it."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from genie_bench.harness import cell as cell_lib, control  # noqa: E402
from genie_bench.harness.program import ROOT  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control_readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cell_lib.load(ROOT, args.workload)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "answer_faults": control.readings(cell, args.seeds, device),
                      "device": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
