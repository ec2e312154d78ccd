"""The port stands alone: importing every `repro_torch` module (and
`chip_smoke` as a module, without running it) pulls in neither jax nor the
JAX package, and nothing runs on the CPU unless the caller asked for it."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import Engine, GenieIndex, SegmentedIndex
from repro_torch.device import resolve_device
from repro_torch.serve import RetrievalService

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_REPO, "src")

_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_module_list_covers_the_slice():
    for name in ("repro_torch.core.plan", "repro_torch.core.lsh.e2lsh",
                 "repro_torch.kernels.build", "repro_torch.kernels.match_count",
                 "repro_torch.kernels.cpq_hist", "repro_torch.serve.retrieval",
                 "repro_torch.core.lsh.simhash", "repro_torch.core.packing",
                 "repro_torch.kernels.cosine_count", "repro_torch.kernels.packed_cosine",
                 "repro_torch.core.lsh.minhash", "repro_torch.core.lsh.rbh",
                 "repro_torch.kernels.tanimoto_count", "repro_torch.kernels.packed_tanimoto",
                 "repro_torch.kernels.range_count", "repro_torch.kernels.minsum_count",
                 "repro_torch.kernels.ip_count", "repro_torch.core.sa",
                 "repro_torch.core.sa.ngram", "repro_torch.core.sa.document",
                 "repro_torch.core.sa.relational", "repro_torch.core.sa.verify",
                 "repro_torch.core.routing", "repro_torch.runtime",
                 "repro_torch.runtime.fault_tolerance", "repro_torch.serve.frontend",
                 "repro_torch.serve.scheduler", "repro_torch.serve.metrics",
                 "repro_torch.core.autotune", "repro_torch.core.distributed",
                 "repro_torch.launch", "repro_torch.launch.mesh",
                 "repro_torch.core.postings", "repro_torch.data.pipeline",
                 "repro_torch.configs", "repro_torch.configs.genie_datasets",
                 "repro_torch.configs.smollm_360m", "repro_torch.configs.qwen2_moe_a2_7b",
                 "repro_torch.configs.internvl2_76b", "repro_torch.models.config",
                 "repro_torch.models.layers", "repro_torch.models.moe",
                 "repro_torch.models.transformer", "repro_torch.models.registry",
                 "repro_torch.serve.engine", "repro_torch.launch.dryrun",
                 "repro_torch.launch.serve", "repro_torch.examples.quickstart",
                 "repro_torch.examples.sequence_search",
                 "repro_torch.examples.ann_kernel_space",
                 "repro_torch.examples.serve_batch", "repro_torch.models.ssm",
                 "repro_torch.models.hybrid", "repro_torch.models.encdec",
                 "repro_torch.configs.mamba2_1_3b", "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.configs.seamless_m4t_large_v2", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                 "repro_torch.optim.compress", "repro_torch.train", "repro_torch.train.step",
                 "repro_torch.train.trainer", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
                 "repro_torch.examples.train_lm", "repro_torch.tree",
                 "repro_torch.launch.sharding", "repro_torch.launch.shapes",
                 "repro_torch.models.partition"):
        assert name in _MODULES


def test_registry_says_training_is_ported():
    from repro_torch.models import registry

    assert "forward only" not in registry.__doc__
    assert "remat" in registry.__doc__


def test_imports_pull_in_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {_SRC!r}); sys.path.insert(0, {_REPO!r})\n"
        f"for name in {_MODULES!r} + ['repro_torch', 'chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_line_imports_jax_or_the_jax_package():
    offenders = []
    roots = [os.path.join(_SRC, "repro_torch"), os.path.join(_REPO, "chip_smoke.py")]
    files = [roots[1]]
    for dirpath, _, names in os.walk(roots[0]):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1 \
                        and words[1].split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert offenders == []


def _init_arch(arch):
    from repro_torch.models.registry import get_api, get_config

    cfg = get_config(arch)
    return get_api(cfg).init_params(cfg, 0)


def _init_state(arch):
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.train import TrainHParams, init_state

    cfg = get_config(arch)
    return init_state(cfg, get_api(cfg), 0, TrainHParams())


def _trainer(arch):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.train import Trainer, TrainerConfig, TrainHParams

    cfg = get_config(arch)
    return Trainer(cfg, get_api(cfg), TrainHParams(), TrainerConfig(), DataConfig())


def _launch_train():
    from repro_torch.launch import train

    return train.main(["--arch", "smollm-360m-smoke", "--steps", "1"])


def _train_lm():
    from repro_torch.examples import train_lm

    return train_lm.main(["--steps", "1"])


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists here")


@pytest.mark.parametrize("build", [
    lambda: RetrievalService(),
    lambda: RetrievalService(embed_fn=lambda items: items, device=None),
    lambda: SegmentedIndex(Engine.EQ),
    lambda: GenieIndex.build(Engine.EQ, [[1, 2], [3, 4]]),
    lambda: GenieIndex.build_lsh([[1, 2], [3, 4]]),
    lambda: resolve_device(None),
    lambda: resolve_device("cuda"),
    lambda: RetrievalService(scheme="simhash", signature_layout="packed"),
    lambda: GenieIndex.build_cosine([[1.0, -2.0], [3.0, 4.0]], signature_layout="packed"),
    lambda: RetrievalService(scheme="minhash", signature_layout="packed"),
    lambda: RetrievalService(scheme="rbh"),
    lambda: GenieIndex.build_tanimoto([[1, 2], [3, 4]], signature_layout="packed"),
    lambda: GenieIndex.build_relational([[1, 2], [3, 4]]),
    lambda: GenieIndex.build_minsum([[1, 2], [3, 4]], max_count=4),
    lambda: GenieIndex.build_ip([[1, 0], [0, 1]], max_count=2),
    lambda: SegmentedIndex(Engine.RANGE),
    lambda: _init_arch("mamba2-1.3b-smoke"),
    lambda: _init_arch("zamba2-2.7b-smoke"),
    lambda: _init_arch("seamless-m4t-large-v2-smoke"),
    lambda: _init_state("smollm-360m-smoke"),
    lambda: _trainer("smollm-360m-smoke"),
    lambda: _launch_train(),
    lambda: _train_lm(),
], ids=["service", "service-device-none", "segmented", "index-build",
        "index-build-lsh", "resolve-none", "resolve-cuda", "service-simhash-packed",
        "index-build-cosine", "service-minhash-packed", "service-rbh",
        "index-build-tanimoto", "index-build-relational", "index-build-minsum",
        "index-build-ip", "segmented-range", "init-ssm", "init-hybrid", "init-audio",
        "train-init-state", "trainer", "launch-train", "examples-train-lm"])
def test_default_device_raises_without_cuda(build):
    """No silent run on the CPU: the default device is the card."""
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_cpu_runs_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    svc = RetrievalService(device="cpu", m_override=8)
    assert svc.device == torch.device("cpu")
    idx = GenieIndex.build(Engine.EQ, [[1, 2], [3, 4]], device="cpu")
    assert idx.data.device.type == "cpu"


def test_chip_smoke_fails_without_cuda():
    """The GPU smoke script exits non-zero and prints no result line where
    there is no CUDA device."""
    _needs_no_cuda()
    out = subprocess.run([sys.executable, os.path.join(_REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
