"""Scene types of the port: volumes, cameras, transforms, volume I/O.

Copies of ``vpt_tpu/scene``'s numpy modules, so the port imports nothing
of the JAX package; ``vpt_tpu_torch.convert`` turns the JAX package's
scene objects into these through plain values and numpy arrays.
"""

from vpt_tpu_torch.scene.camera import Camera, OrbitController  # noqa: F401
from vpt_tpu_torch.scene.transform import Node, Transform  # noqa: F401
from vpt_tpu_torch.scene.volume import Volume  # noqa: F401
