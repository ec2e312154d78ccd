# Launch layer: device meshes on torch.distributed (launch/mesh.py), the GENIE
# dry-run (launch/dryrun.py) and the serving launcher (launch/serve.py), the
# counterparts of the reference's modules of those names; its sharding,
# shapes and training launchers are ROADMAP queue 1 item 11c.
from repro_torch.launch import mesh  # noqa: F401
