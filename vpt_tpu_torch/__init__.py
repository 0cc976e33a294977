"""vpt_tpu_torch — the PyTorch + CUDA port of vpt_tpu for NVIDIA Hopper.

The JAX package ``vpt_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``kernels/``, ``models/``, ``postprocess/``,
``session.py``) and runs the spectral forward render: plain PyTorch on CPU
tensors, hand-written CUDA kernels (``csrc/``, built with nvcc for sm_90a
on first use) on CUDA tensors. It never imports jax; the scene, camera and
config types come from ``vpt_tpu``'s jax-free modules.
"""

__version__ = "0.1.0"

from vpt_tpu.scene.camera import Camera  # noqa: F401
from vpt_tpu.scene.volume import Volume  # noqa: F401
from vpt_tpu.utils.config import (  # noqa: F401
    LightConfig,
    MaterialTF,
    MCMSpectralConfig,
    SpectrumConfig,
)
