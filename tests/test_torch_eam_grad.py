"""The EAM ray marcher's training (vpt_tpu_torch/optim.py: eam_loss,
make_inverse_step, fit_density; kernels/raymarch.py: eam_frame_diff,
eam_backward) against vpt_tpu's on the CPU, where the port's
differentiable frame is the plain eam_frame under torch autograd (the
card's K15 forward and K19 backward are held against these plain versions
by chip_smoke.py's phase 20).

Scenes: tests/test_inverse.py's blob (D = 12) and TF (white, alpha ramp
along the density) at R = 32 (its 48 cut down), 24 slices, extinction 60;
tests/test_grad_fd.py's EAM scene for the finite differences.

Tolerances, and why:
- Gradients against jax.grad of vpt_tpu.optim.eam_loss: within 2e-4 of
  max|g| (linear, quasicubic; both TF and density). The port and XLA sum
  the same terms in other orders, and XLA's CPU code contracts the lerps
  into FMAs, so sample positions differ by an ulp on ~30% of rays. Under
  the nearest filter such an ulp can move a sample onto the next voxel,
  which then takes that sample's whole gradient: there 99% of voxels must
  meet the tolerance.
- The per-voxel JVP against central differences of the port's forward and
  of the NumPy oracle (vpt_tpu/reference/eam_numpy.py): atol 5e-3 of the
  differences' scale on the pixels whose one-sided slopes agree (kinks of
  the 0.99 early-out and the clamps inside the FD interval excluded), as
  tests/test_grad_fd.py holds jax.jvp.
- Trajectories of make_inverse_step against JAX's: losses rtol 1e-4,
  params atol 5e-4, over 10 Adam steps of the density, 5 of the density
  and the TF. Adam divides each gradient by its own root mean square, so an
  element whose gradient is ~1e-6 of the largest moves by up to the
  learning rate, and there rounding decides: at equal params the two
  packages' TF gradients differ by up to 28% on such texels from step 6 of
  this scene on (by < 1e-4 of max|g| everywhere), after which the two
  trajectories part by a few percent of the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vpt_tpu import optim as JO
from vpt_tpu.models.raymarch import eam_frame as jax_eam_frame
from vpt_tpu.reference.eam_numpy import eam_frame_numpy
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import raymarch as K
from vpt_tpu_torch.models import raymarch as TR
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene.camera import Camera
from vpt_tpu_torch.scene.camera import OrbitController
from vpt_tpu_torch.scene.volume import Volume

torch.set_num_threads(1)

RES, D, SLICES, EXT = 32, 12, 24, 60.0
FILTERS = ("linear", "quasicubic", "nearest")
GRAD_TOL = 2e-4


def _tf():
    tf = np.zeros((256, 256, 4), np.float32)
    tf[..., :3] = 1.0
    tf[..., 3] = np.linspace(0, 1, 256)[None, :]
    return tf


def _blob(size=D):
    x, y, z = np.meshgrid(*([np.linspace(-1, 1, size)] * 3), indexing="ij")
    return np.exp(-((x + 0.2) ** 2 + y ** 2 + (z - 0.1) ** 2) / 0.18).astype(np.float32)


def _cameras(views, pitch=-0.3):
    """The same orbit poses for both packages."""
    out = []
    for k in range(views):
        jc, tc = JCamera(), Camera()
        JOrbit(yaw=2 * np.pi * k / views, pitch=pitch).apply(jc)
        OrbitController(yaw=2 * np.pi * k / views, pitch=pitch).apply(tc)
        out.append((jc, tc))
    return out


def _targets(cams, density, tf):
    return [np.array(jax_eam_frame(jnp.asarray(jc.inverse_mvp()), jnp.asarray(density),
                                     jnp.asarray(tf), jnp.float32(EXT), jnp.float32(0.0),
                                     slices=SLICES, resolution=RES)) for jc, _ in cams]


def _static(tf, filt="linear", jax_side=False):
    table = jnp.asarray(tf) if jax_side else torch.as_tensor(tf)
    ext = jnp.float32(EXT) if jax_side else EXT
    return dict(tf_table=table, extinction=ext, slices=SLICES, resolution=RES,
                volume_filter=filt)


@pytest.mark.parametrize("filt", FILTERS)
def test_eam_loss_gradients_match_jax(filt):
    """d eam_loss / d (density, tf_table) through eam_frame_diff == jax.grad
    of vpt_tpu.optim.eam_loss, at a random coloured TF and a random target."""
    rng = np.random.default_rng(11)
    tf = _tf()
    tf[..., :3] = rng.uniform(0.3, 1.0, (1, 256, 3)).astype(np.float32)
    density = _blob() * 0.8
    target = rng.uniform(0.0, 0.5, (RES, RES, 3)).astype(np.float32)
    (jc, tc), = _cameras(1)
    JOrbit(yaw=0.7, pitch=-0.3).apply(jc)
    OrbitController(yaw=0.7, pitch=-0.3).apply(tc)
    offset = np.float32(0.3)

    pj = {"density": jnp.asarray(density), "tf_table": jnp.asarray(tf)}
    lj, gj = jax.value_and_grad(JO.eam_loss)(pj, jnp.asarray(jc.inverse_mvp()), offset,
                                             jnp.asarray(target), _static(tf, filt, True))
    pt = {"density": torch.tensor(density, requires_grad=True),
          "tf_table": torch.tensor(tf, requires_grad=True)}
    lt = TO.eam_loss(pt, tc.inverse_mvp(), offset, torch.as_tensor(target), _static(tf, filt))
    gt = dict(zip(pt, torch.autograd.grad(lt, list(pt.values()))))

    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for key in pt:
        want, got = np.asarray(gj[key]), gt[key].numpy()
        scale = np.abs(want).max()
        assert scale > 0, key
        ok = np.abs(got - want) <= GRAD_TOL * scale
        share = 0.99 if filt == "nearest" and key == "density" else 1.0
        assert ok.mean() >= share, (key, ok.mean(), np.abs(got - want).max() / scale)


def _fd_scene():
    """tests/test_grad_fd.py's EAM scene."""
    vol = Volume.sphere_in_cube(8)
    tf = np.zeros((256, 256, 4), np.float32)
    ramp = np.linspace(0, 1, 256)[None, :]
    tf[..., 0] = 0.9
    tf[..., 1] = 0.3 + 0.5 * ramp
    tf[..., 2] = 0.7
    tf[..., 3] = 0.8 * ramp
    return Camera().inverse_mvp(), np.asarray(vol.density, np.float32), tf


def test_eam_voxel_jvp_matches_fd_and_numpy_oracle():
    """d(image)/d(voxel) through the port's reverse mode (the JVP as the
    transpose of its vector-Jacobian product) == central differences of
    the port's forward == those of the NumPy oracle, for the three most
    influential voxels."""
    res, slices, ext, off = 16, 24, 30.0, 0.3
    inv, dens_np, tf_np = _fd_scene()
    tf = torch.as_tensor(tf_np)

    def forward(d):
        return TR.eam_frame_diff(inv, d, tf, ext, off, slices, res)

    dens = torch.as_tensor(dens_np)
    base = forward(dens).numpy()
    assert base.max() > 0.01, "the scene renders something"
    d_leaf = dens.clone().requires_grad_(True)
    g = torch.autograd.grad(forward(d_leaf).sum(), d_leaf)[0].numpy()
    voxels = [np.unravel_index(i, g.shape) for i in np.argsort(np.abs(g).ravel())[::-1][:3]]
    eps = 1e-2
    for v in voxels:
        e = torch.zeros_like(dens)
        e[v] = 1.0
        _, jvp = torch.autograd.functional.jvp(forward, dens, e)
        jvp = jvp.numpy()
        ip, im = forward(dens + eps * e).numpy(), forward(dens - eps * e).numpy()
        fd = (ip - im) / (2 * eps)
        scale = max(np.abs(fd).max(), 1e-4)
        assert np.abs(jvp).max() > 1e-4, "the voxel has influence"
        smooth = np.abs((ip - base) / eps - (base - im) / eps) < 1e-2 * scale
        assert smooth.mean() > 0.95, "most pixels are kink-free"
        np.testing.assert_allclose((jvp / scale)[smooth], (fd / scale)[smooth], atol=5e-3)
        e_np = e.numpy()
        op = eam_frame_numpy(inv, dens_np + eps * e_np, tf_np, ext, off, slices, res)
        om = eam_frame_numpy(inv, dens_np - eps * e_np, tf_np, ext, off, slices, res)
        np.testing.assert_allclose((jvp / scale)[smooth], ((op - om) / (2 * eps) / scale)[smooth],
                                   atol=5e-3)


@pytest.mark.parametrize("learn_tf", [False, True])
def test_make_inverse_step_trajectory_matches_jax(learn_tf):
    """Adam steps of make_inverse_step over four views, from one init (10
    learning the density, 5 learning the TF too): the port's losses and
    params follow JAX's."""
    tf = _tf()
    cams = _cameras(4)
    targets = _targets(cams, _blob(), tf)
    init = np.full((D, D, D), 0.2, np.float32)
    lr = 0.08

    pj = {"density": jnp.asarray(init)}
    pt = {"density": torch.as_tensor(init)}
    if learn_tf:
        pj["tf_table"], pt["tf_table"] = jnp.asarray(tf * 0.8), torch.as_tensor(tf * 0.8)
    sj = JO.InverseState(pj, optax.adam(lr).init(pj), jnp.zeros((), jnp.int32))
    step_j = JO.make_inverse_step(optax.adam(lr), _static(tf, jax_side=True), learn_tf)
    opt = TO.Adam(lr)
    st = TO.InverseState(pt, opt.init(pt), 0)
    step_t = TO.make_inverse_step(opt, _static(tf), learn_tf)
    losses_j, losses_t = [], []
    steps = 5 if learn_tf else 10
    for i in range(steps):
        k = i % len(cams)
        off = np.float32(TR._seed_to_offset(i))
        sj, lj = step_j(sj, jnp.asarray(cams[k][0].inverse_mvp()), off, jnp.asarray(targets[k]))
        st, lt = step_t(st, cams[k][1].inverse_mvp(), off, torch.as_tensor(targets[k]))
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    assert st.step == steps and st.opt_state["count"] == steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    for key in pt:
        got, want = st.params[key].numpy(), np.asarray(sj.params[key])
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=key)
        assert got.min() >= 0.0 and got.max() <= 1.0, key


def test_fit_density_recovers_the_blob():
    """test_inverse.py::test_density_recovery at R = 32 and 60 iterations:
    the loss falls, the MAE halves, the blob's peak lands near the truth's."""
    tf = _tf()
    truth = _blob()
    cams = _cameras(4)
    targets = _targets(cams, truth, tf)
    init = np.full_like(truth, 0.2)
    params, losses = TO.fit_density(targets, [tc for _, tc in cams], init, tf, extinction=EXT,
                                    slices=SLICES, resolution=RES, iterations=60,
                                    learning_rate=0.08, device="cpu")
    rec = params["density"].numpy()
    assert isinstance(losses, np.ndarray) and losses.shape == (60,)
    assert losses[-1] < losses[0] * 0.05, f"loss barely moved: {losses[0]} -> {losses[-1]}"
    assert np.abs(rec - truth).mean() < np.abs(init - truth).mean() * 0.5
    idx = np.unravel_index(np.argmax(rec), rec.shape)
    idx_t = np.unravel_index(np.argmax(truth), truth.shape)
    assert np.abs(np.array(idx) - np.array(idx_t)).max() <= 3


def test_fit_density_learns_the_tf_jointly():
    """test_inverse.py::test_learn_tf_jointly at R = 32."""
    tf = _tf()
    truth = _blob()
    cams = _cameras(4)
    targets = _targets(cams, truth, tf)
    params, losses = TO.fit_density(targets, [tc for _, tc in cams], truth * 0.5, tf * 0.8,
                                    extinction=EXT, slices=SLICES, resolution=RES,
                                    learn_tf=True, iterations=30, learning_rate=0.05,
                                    device="cpu")
    assert set(params) == {"density", "tf_table"}
    assert losses[-1] < losses[0]
    got = params["tf_table"].numpy()
    assert np.isfinite(got).all() and np.abs(got - tf * 0.8).max() > 0
    assert got.min() >= 0.0 and got.max() <= 1.0


def _two_steps(step, state, cams, targets, jax_side):
    for i in range(2):
        off = np.float32(TR._seed_to_offset(i))
        if jax_side:
            state, _ = step(state, jnp.asarray(cams[i][0].inverse_mvp()), off,
                            jnp.asarray(targets[i]))
        else:
            state, _ = step(state, cams[i][1].inverse_mvp(), off, torch.as_tensor(targets[i]))
    return state


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_eam_checkpoints_interchange_with_jax(direction, tmp_path):
    """An EAM InverseState ({density, tf_table}, Adam, step) saved by one
    package loads in the other: port -> JAX bit for bit; JAX -> port, the
    port's next step from JAX's state follows JAX's own next step."""
    tf = _tf()
    cams = _cameras(3)
    targets = _targets(cams, _blob(), tf)
    init = np.full((D, D, D), 0.3, np.float32)
    lr = 0.05
    pj = {"density": jnp.asarray(init), "tf_table": jnp.asarray(tf)}
    sj = JO.InverseState(pj, optax.adam(lr).init(pj), jnp.zeros((), jnp.int32))
    step_j = JO.make_inverse_step(optax.adam(lr), _static(tf, jax_side=True), True)
    opt = TO.Adam(lr)
    pt = {"density": torch.as_tensor(init), "tf_table": torch.as_tensor(tf)}
    st = TO.InverseState(pt, opt.init(pt), 0)
    step_t = TO.make_inverse_step(opt, _static(tf), True)
    path = str(tmp_path / "eam.npz")
    if direction == "port_to_jax":
        st = _two_steps(step_t, st, cams, targets, jax_side=False)
        TO.save_inverse_checkpoint(path, st)
        loaded = JO.load_inverse_checkpoint(path, sj)
        assert int(loaded.step) == 2 and int(loaded.opt_state[0].count) == 2
        for key in pt:
            np.testing.assert_array_equal(np.asarray(loaded.params[key]), st.params[key].numpy())
            np.testing.assert_array_equal(np.asarray(loaded.opt_state[0].nu[key]),
                                          st.opt_state["nu"][key].numpy())
        return
    sj = _two_steps(step_j, sj, cams, targets, jax_side=True)
    JO.save_inverse_checkpoint(path, sj)
    loaded = TO.load_inverse_checkpoint(path, st)
    assert loaded.step == 2 and loaded.opt_state["count"] == 2
    off = np.float32(TR._seed_to_offset(2))
    sj, lj = step_j(sj, jnp.asarray(cams[2][0].inverse_mvp()), off, jnp.asarray(targets[2]))
    st, lt = step_t(loaded, cams[2][1].inverse_mvp(), off, torch.as_tensor(targets[2]))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    assert st.step == 3
    for key in pt:
        np.testing.assert_allclose(st.params[key].numpy(), np.asarray(sj.params[key]), atol=5e-4,
                                   err_msg=key)


def test_fit_density_on_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="A12"):
        TO.fit_density([np.zeros((8, 8, 3), np.float32)], [Camera()],
                       np.zeros((4, 4, 4), np.float32), _tf(), resolution=8, iterations=1,
                       mesh=object(), device="cpu")


def test_differentiable_frame_refuses_what_k19_does_not_take():
    """Packed tables, more samples a ray than K19 keeps, a wider TF than
    its shared row: ValueError on every device."""
    dens = torch.as_tensor(_blob())
    tf = torch.as_tensor(_tf())
    inv = Camera().inverse_mvp()
    packed = interp.pack_volume_auto(_blob(), "cpu", "full")
    g = torch.zeros((8, 8, 3))
    with pytest.raises(ValueError, match="raw"):
        TR.eam_frame_diff(inv, packed, tf, EXT, 0.0, SLICES, 8)
    with pytest.raises(ValueError, match="raw"):
        K.eam_backward(g, inv, dens, torch.as_tensor(interp.pack_tex2d_corners(_tf())), EXT, 0.0,
                       SLICES)
    with pytest.raises(ValueError, match="slices"):
        TR.eam_frame_diff(inv, dens, tf, EXT, 0.0, K.EAM_BACKWARD_MAX_TRIPS, 8)
    with pytest.raises(ValueError, match="columns"):
        K.eam_backward(g, inv, dens, torch.zeros((1, K.EAM_BACKWARD_MAX_TF_W + 1, 4)), EXT, 0.0,
                       SLICES)


def test_backward_on_the_cpu_is_the_plain_version():
    """eam_backward routes CPU tensors to eam_backward_plain (no launch), and
    its gradients are the autograd gradients of <g, eam_frame>."""
    rng = np.random.default_rng(4)
    dens, tf = torch.as_tensor(_blob()), torch.as_tensor(_tf())
    inv = Camera().inverse_mvp()
    g = torch.as_tensor(rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32))
    before = dict(K.LAUNCHES)
    gd, gt = K.eam_backward(g, inv, dens, tf, EXT, 0.2, SLICES, "linear", learn_tf=True)
    assert K.LAUNCHES == before
    d, t = dens.clone().requires_grad_(True), tf.clone().requires_grad_(True)
    img = K.eam_frame(inv, d, t, EXT, 0.2, SLICES, 16)
    wd, wt = torch.autograd.grad((img * g).sum(), [d, t])
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6 * float(wd.abs().max()))
    torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-6 * float(wt.abs().max()))
    assert K.eam_backward(g, inv, dens, tf, EXT, 0.2, SLICES)[1] is None
