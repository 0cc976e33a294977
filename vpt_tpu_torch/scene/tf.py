"""Classic 2D transfer function built from Gaussian bumps.

The port's copy of ``vpt_tpu/scene/tf.py`` (numpy only): the same bumps,
the same float64 blend and u8 quantization, so ``rasterize`` gives the JAX
package's table bit for bit, and the same JSON, so each package loads the
other's. ``vpt_tpu_torch.convert.tf2d_from`` carries a JAX
``TransferFunction2D`` across as plain values.

The reference's TF editor renders additive Gaussian "bumps" into a 256x256
RGBA8 canvas with premultiplied-alpha blending and feeds the canvas straight
to the renderers as the TF texture:
  - bump fragment: color * exp(-r^2), r = |(pos - p)/size|
  - blending: dst = src + dst*(1 - src.a) (gl.ONE, gl.ONE_MINUS_SRC_ALPHA)
  - bump JSON save/load: a list of {position, size, color} objects

TF coordinate convention (as consumed by the renderers): x = density,
y = second volume channel (gradient magnitude; 0 for scalar volumes).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np


def default_bump() -> dict:
    return {
        "position": {"x": 0.5, "y": 0.5},
        "size": {"x": 0.2, "y": 0.2},
        "color": {"r": 1.0, "g": 0.0, "b": 0.0, "a": 1.0},
    }


@dataclass(frozen=True)
class TransferFunction2D:
    """A list of Gaussian bumps rasterized to a float RGBA table."""

    bumps: tuple = ()
    width: int = 256
    height: int = 256

    def rasterize(self, quantize: bool = True) -> np.ndarray:
        """Blend the bumps into a (height, width, 4) float32 table in [0,1].

        ``quantize`` rounds through uint8 like the reference's RGBA8 canvas.
        Blend order matters (premultiplied over): bumps composite in order.
        """
        H, W = self.height, self.width
        # pixel centers in [0,1] (canvas raster space)
        ys = (np.arange(H) + 0.5) / H
        xs = (np.arange(W) + 0.5) / W
        py, px = np.meshgrid(ys, xs, indexing="ij")
        out = np.zeros((H, W, 4), np.float64)
        for bump in self.bumps:
            p, s, c = bump["position"], bump["size"], bump["color"]
            rx = (p["x"] - px) / s["x"]
            ry = (p["y"] - py) / s["y"]
            g = np.exp(-(rx * rx + ry * ry))
            src = np.stack([c["r"] * g, c["g"] * g, c["b"] * g, c["a"] * g], axis=-1)
            out = src + out * (1.0 - src[..., 3:4])
        out = np.clip(out, 0.0, 1.0)
        if quantize:
            out = np.round(out * 255.0) / 255.0
        return out.astype(np.float32)

    # -- (de)serialization (same JSON shape the reference saves) -----------
    def to_json(self) -> str:
        return json.dumps(list(self.bumps))

    @staticmethod
    def from_json(data: str) -> "TransferFunction2D":
        return TransferFunction2D(tuple(json.loads(data)))

    @staticmethod
    def from_bumps(bumps: List[dict]) -> "TransferFunction2D":
        return TransferFunction2D(tuple(bumps))

    @staticmethod
    def grayscale_ramp(alpha_scale: float = 1.0) -> "TransferFunction2D":
        """A simple density-proportional TF useful for tests and demos."""
        bumps = [
            {
                "position": {"x": x, "y": 0.0},
                "size": {"x": 0.25, "y": 2.0},
                "color": {"r": x, "g": x, "b": x, "a": min(1.0, x * alpha_scale)},
            }
            for x in (0.4, 0.7, 0.95)
        ]
        return TransferFunction2D(tuple(bumps))
