# Launch layer: device meshes on torch.distributed (the counterpart of the
# reference's launch/mesh.py; the rest of that package is ROADMAP queue 1
# items 10 and 11).
from repro_torch.launch import mesh  # noqa: F401
