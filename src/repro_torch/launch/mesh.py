"""Device meshes on torch.distributed: the counterpart of
`repro/launch/mesh.py`, name for name.

single pod : (data=16, model=16)            -- 256 devices
multi pod  : (pod=2, data=16, model=16)     -- 512 devices

JAX runs the reference from one controller that owns every device of its
`Mesh`.  PyTorch runs one process per rank, every rank running the same
program (SPMD), and a mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group: every rank builds it, with the
same shape, in the same order as its other collectives.

The backend follows the device: NCCL on `cuda` (`device=None` means the
card, `device.resolve_device`), gloo on `cpu`.  A mesh on a device whose
backend the default group does not carry raises; no group is ever replaced
by another.  Where no process group exists yet, `make_mesh` and
`make_local_mesh` start one of world size 1 themselves -- a file store in a
temporary directory, nothing on the network -- so one process on one card
needs no launcher.  A mesh of several ranks needs its ranks started first,
each calling `torch.distributed.init_process_group` with the world's size and
its own rank.

FUNCTIONS, not module-level constants: importing this module starts no
process group.

The rest of the reference's launch package is not ported here: the
parameter sharding policy (`sharding.py`), the input shapes (`shapes.py`)
and the train / serve drivers (`train.py`, `serve.py`) belong to the LM
scaffolding (ROADMAP queue 1 item 11), and the dry-run (`dryrun.py`) to
queue 1 items 10 and 11.
"""
from __future__ import annotations

import atexit
import contextlib
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# the process-group backend a mesh of each device type needs
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _close_group(store_dir: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def _ensure_group(device: torch.device) -> None:
    """Check the default process group's backend against `device`, or start
    a group of world size 1 when there is none."""
    want = _BACKEND.get(device.type)
    if want is None:
        raise ValueError(f"no process-group backend for a {device.type!r} mesh")
    if dist.is_initialized():
        have = str(dist.get_backend())
        if want not in have:
            raise RuntimeError(
                f"a {device.type} mesh needs the {want} backend, and the default "
                f"process group runs {have}: start the group with backend={want!r}")
        return
    store_dir = tempfile.mkdtemp(prefix="genie_group_")
    kw = {}
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(want, init_method="file://" + os.path.join(store_dir, "store"),
                            world_size=1, rank=0, **kw)
    atexit.register(_close_group, store_dir)


def make_mesh(shape, axes, device: DeviceLike = None):
    """A DeviceMesh of `shape` named `axes` over every rank of the default
    process group (started here, world size 1, when there is none), on
    `device`'s type.  Like `jax.make_mesh`, the mesh takes every rank: the
    product of `shape` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    _ensure_group(dev)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {shape} mesh needs {math.prod(shape)} ranks and the process group "
            f"has {world}: start one rank per device before making the mesh")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def use_mesh(mesh):
    """The ambient mesh for DTensor operations, as the reference's
    `jax.sharding.set_mesh`."""
    with mesh:
        yield mesh


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, device: DeviceLike = None):
    """Mesh over whatever ranks exist (one, started here, when no process
    group exists): (world // model_parallel, model_parallel)."""
    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the {n} ranks")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), dev)


def dp_axes(mesh) -> tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    return ("pod", "data") if "pod" in names else ("data",)


def dp_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return int(math.prod(sizes[a] for a in dp_axes(mesh)))


def tp_size(mesh) -> int:
    return int(dict(zip(mesh.mesh_dim_names, mesh.shape))["model"])
