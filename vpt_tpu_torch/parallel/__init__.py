"""Multi-rank rendering on ``torch.distributed``: the ray mesh
(``mesh.py``, rows of the framebuffer split across ranks, scene tables
replicated) and the z-slab-sharded volume (``slab.py``, the packed corner
table split into z-slabs, one a rank, under a routed gather per step)."""
