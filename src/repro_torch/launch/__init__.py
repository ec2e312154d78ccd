# Launch layer: device meshes on torch.distributed (launch/mesh.py), the
# sharding policy on DTensor (launch/sharding.py), the dry-run cells' input
# shapes (launch/shapes.py), the dry-run (launch/dryrun.py), the serving
# launcher (launch/serve.py) and the training launcher (launch/train.py), the
# counterparts of the reference's modules of those names.
from repro_torch.launch import mesh  # noqa: F401
