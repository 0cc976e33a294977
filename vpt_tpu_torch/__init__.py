"""vpt_tpu_torch — the PyTorch + CUDA port of vpt_tpu for NVIDIA Hopper.

The JAX package ``vpt_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``kernels/``, ``models/``, ``postprocess/``,
``session.py``) and runs the spectral renderer (forward and gradients)
and the ray marchers (EAM, MIP, ISO, Depth): plain PyTorch on CPU
tensors, hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a
on first use) on CUDA tensors. It imports nothing of ``vpt_tpu`` or jax: it carries its own
copies of the scene, camera and config types (``scene/``, ``utils/``), the
majorant builder (``ops/majorant.py``) and the CIE data (``data/``).
"""

__version__ = "0.1.0"

from vpt_tpu_torch.scene.camera import Camera  # noqa: F401
from vpt_tpu_torch.scene.volume import Volume  # noqa: F401
from vpt_tpu_torch.utils.config import (  # noqa: F401
    LightConfig,
    MaterialTF,
    MCMSpectralConfig,
    SpectrumConfig,
)
