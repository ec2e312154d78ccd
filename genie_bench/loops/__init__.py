"""The traffic loops: one driver module per kind of loop, named by a mix's
`loop` (see harness/traffic.py)."""
