# Launch layer: device meshes on torch.distributed (launch/mesh.py), the GENIE
# dry-run (launch/dryrun.py), the serving launcher (launch/serve.py) and the
# training launcher on one rank (launch/train.py), the counterparts of the
# reference's modules of those names; its sharding and shapes are ROADMAP
# queue 1 item 11c-ii.
from repro_torch.launch import mesh  # noqa: F401
