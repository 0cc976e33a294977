"""The port's TransferFunction2D (vpt_tpu_torch/scene/tf.py) against
vpt_tpu's: the same table bit for bit, the JSON of each package loading in
the other, ``convert.tf2d_from``, and the goldens' ``rasterize`` override."""

import json

import numpy as np
import pytest

from vpt_tpu.models import raymarch as JR
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.tf import default_bump as jax_default_bump
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu_torch import convert
from vpt_tpu_torch.models import raymarch as TR
from vpt_tpu_torch.scene.tf import TransferFunction2D, default_bump


def _random_bumps(seed, n=4):
    rng = np.random.default_rng(seed)
    return [{"position": {"x": float(rng.uniform()), "y": float(rng.uniform())},
             "size": {"x": float(rng.uniform(0.05, 0.5)), "y": float(rng.uniform(0.05, 2.0))},
             "color": {k: float(rng.uniform()) for k in "rgba"}} for _ in range(n)]


CASES = {
    "grayscale_ramp": lambda: JTF.grayscale_ramp(),
    "ramp_alpha_2": lambda: JTF.grayscale_ramp(2.0),
    "default_bump": lambda: JTF.from_bumps([jax_default_bump()]),
    "random": lambda: JTF.from_bumps(_random_bumps(11)),
    "empty": lambda: JTF(),
    "64x32": lambda: JTF(tuple(_random_bumps(12, 3)), width=64, height=32),
}


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_matches_jax_bit_for_bit(case, quantize):
    jtf = CASES[case]()
    ttf = convert.tf2d_from(jtf)
    assert isinstance(ttf, TransferFunction2D)
    a, b = jtf.rasterize(quantize), ttf.rasterize(quantize)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (jtf.height, jtf.width, 4)
    np.testing.assert_array_equal(b, a)
    if quantize:
        np.testing.assert_array_equal(np.round(b * 255.0) / 255.0, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_loads_in_the_other_package(case):
    jtf = CASES[case]()
    ttf = TransferFunction2D.from_json(jtf.to_json())
    assert json.loads(ttf.to_json()) == json.loads(jtf.to_json())
    back = JTF.from_json(ttf.to_json())
    if (jtf.width, jtf.height) == (256, 256):
        np.testing.assert_array_equal(ttf.rasterize(), jtf.rasterize())
        np.testing.assert_array_equal(back.rasterize(), jtf.rasterize())
    assert back.bumps == jtf.bumps


def test_tf2d_from_copies_plain_values():
    jtf = JTF.from_bumps(_random_bumps(13))
    ttf = convert.tf2d_from(jtf)
    assert ttf.bumps == jtf.bumps and ttf.bumps is not jtf.bumps
    ttf.bumps[0]["color"]["r"] = -1.0  # the copy is the port's own
    assert jtf.bumps[0]["color"]["r"] != -1.0
    assert convert.scene_from(jtf).bumps == jtf.bumps
    assert default_bump() == jax_default_bump()


def test_rasterize_override_reaches_the_tables_like_the_goldens():
    """tests/golden_tools.py replaces ``rasterize`` on a frozen instance;
    the port's copy takes the override and its packer reads it, as JAX's."""
    table = np.zeros((256, 256, 4), np.float32)
    table[..., :3] = (0.9, 0.7, 0.5)
    table[..., 3] = np.linspace(0, 1, 256)[None, :]
    jtf, ttf = JTF(), TransferFunction2D()
    for tf in (jtf, ttf):
        object.__setattr__(tf, "rasterize", lambda quantize=True: table)
    vol = JVolume.sphere_in_cube(8)
    _, jt = JR._pack_if_linear(vol, jtf)
    _, tt = TR._pack_if_linear(convert.volume_from(vol), ttf, "cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    vol.filter = "nearest"
    _, jt = JR._pack_if_linear(vol, jtf)
    _, tt = TR._pack_if_linear(convert.volume_from(vol), ttf, "cpu")
    np.testing.assert_array_equal(tt.numpy(), table)
    np.testing.assert_array_equal(np.asarray(jt), table)
