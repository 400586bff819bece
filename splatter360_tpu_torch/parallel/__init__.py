"""Training and evaluation across cards (torch.distributed): the rank grid
and collectives (mesh.py) and the band- and face-sharded renders
(render_sharding.py)."""
