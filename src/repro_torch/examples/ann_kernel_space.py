"""ANN search in Laplacian kernel space via Random Binning Hashing (paper
section IV-A3, the OCR experiment): kernel-width heuristic, RBH signatures,
re-hashing to a finite bucket space, and 1NN label prediction.

    python -m repro_torch.examples.ann_kernel_space [--device cpu]

The counterpart of `examples/ann_kernel_space.py`.  `main` returns the
accuracy and the kernel launches of the search.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GenieIndex
from repro_torch.core.lsh import rbh
from repro_torch.data.pipeline import synthetic_points
from repro_torch.device import resolve_device
from repro_torch.kernels.common import launches_during


def main(device=None, *, n_points: int = 10_000, d: int = 32, m: int = 128,
         n_test: int = 1000) -> dict:
    dev = resolve_device(device)
    pts, labels = synthetic_points(n_points, d, n_clusters=26, seed=4)
    pts_t = torch.from_numpy(pts).to(dev)

    sigma = rbh.median_heuristic_sigma(pts_t, torch.Generator().manual_seed(0))
    print(f"kernel width sigma = {sigma:.2f} (mean pairwise l1, Jaakkola heuristic)")
    params = rbh.make(torch.Generator().manual_seed(1), d=d, m=m, sigma=sigma,
                      n_buckets=8192, device=dev)

    train, test = pts_t[n_test:], pts_t[:n_test]
    ltrain, ltest = labels[n_test:], labels[:n_test]
    index = GenieIndex.build_lsh(rbh.hash_points(params, train), max_count=m,
                                 use_kernel=dev.type != "cpu", device=dev)
    res, launches = launches_during(lambda: index.search(rbh.hash_points(params, test), k=1))
    pred = ltrain[res.ids[:, 0].cpu().numpy()]
    accuracy = float(np.mean(pred == ltest))
    print(f"1NN label prediction accuracy: {accuracy:.3f} "
          f"(paper Table V: 0.837 on real OCR)")

    # collision probability sanity: empirical vs Laplacian kernel
    x, y = train[0], train[0] + 0.05
    emp = float(torch.mean((rbh.hash_points(params, x) == rbh.hash_points(params, y)).float()))
    theo = float(rbh.kernel(x, y, sigma))
    print(f"collision prob: empirical {emp:.3f} vs kernel {theo:.3f}")
    return {"accuracy": accuracy, "collision": (emp, theo), "launches": {"rbh": launches}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
