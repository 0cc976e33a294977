"""The single-scattering MCS kernels: wrappers, plain versions, launch counts.

Two kernels of ``vpt_tpu_torch/csrc/mcs.cu``:

- ``frames`` (K22 ``mcs_frames``): K frames of the reference-exact frame
  path merged into the running mean ``acc`` in place (replaces
  ``vpt_tpu/models/mcs.py::_mcs_frame_impl`` looped by ``mcs_frames``);
  plain version ``frames_plain``. K22 is an instance per table pair
  (``persistent_mode``, which names K22's instances too) and majorant.
- ``persistent`` (K23 ``mcs_persistent``): K dispatches of ``steps``
  iterations of the persistent-lane state machine, the lane state updated
  in place (replaces ``_mcs_persistent_dispatch_impl`` looped by
  ``mcs_persistent_many``); plain version ``persistent_plain``. K23 is an
  instance per table pair (``persistent_mode``) and majorant.

Per pixel and frame: a Woodcock free flight along the camera ray to a real
collision or an escape (``_woodcock_distance``), a ratio-tracked
transmittance from the collision toward the frame's scattering direction
(``_woodcock_transmittance``), and diffuse x light x transmittance, or the
environment on a miss or an escape. Both loops can run against the
super-voxel majorant (``_majorant_lookup``). The plain versions keep the
JAX names, signatures and masked loops: all-lanes-done exits capped at
``max_collisions`` iterations, an active lane taking one trip per
iteration, draws only where the reference's mask is on.

The tables: the volume a packed "full" corner table (u8 or f32; linear or
quasicubic filter) or a raw (D, H, W) f32 grid (also nearest); the classic
2D TF the packed (257, 257, 16) corner table or the raw (256, 256, 4)
texture, read at (density, 0); the environment a raw (He, We, 3) equirect
map (the renderer's default is one white texel); the majorant an optional
(Gz, Gy, Gx, 2) f32 grid.

Persistent lanes (``MCSPersistentState``, lane shape (R, R), or (S, R, R)
over S streams): each iteration a lane takes one free-flight step along its
segment, the camera ray's stretch inside the cube (distance phase) or the
shadow ray from its scatter point along a direction drawn per sample
(shadow phase). A real collision in the distance phase turns the lane into
a shadow ray; a shadow ray ratio-tracks its transmittance; an escape
deposits the environment (distance phase) or diffuse x light x
transmittance (shadow phase) into the lane's incremental mean and starts
the next sample. Each dispatch reseeds the lane's chain from its uv bits
and the dispatch's seed (``persistent_seeds``); only the lane state carries
over.

The wrappers run the plain version when their tensors lie on the CPU and
launch the kernel when they lie on one CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches (never plain runs); a launch also
counts under each mode it ran: ``*_majorant``, ``*_raw`` (a raw grid and
TF), ``*_environment`` (a map of more than one texel) and
``persistent_streams`` (more than one stream).
The plain versions take tensors on any device, so tests and
``chip_smoke.py`` compare kernel and plain version on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import raymarch as RK
from vpt_tpu_torch.kernels.mcm import sample_environment
from vpt_tpu_torch.kernels.raymarch import _mix3, camera_rays, ray_bounds
from vpt_tpu_torch.ops import geometry, interp, sampling

# must match SF_COUNT / SI_COUNT in csrc/mcs.cu
_F_COUNT = 18
_I_COUNT = 21
# K23's instances, in the order of csrc/mcs.cu McsMode
PERSISTENT_MODES = ("u8", "f32", "u8 quasicubic", "f32 quasicubic", "nearest", "generic")

# MCSPersistentState's fields, in the JAX state's leaf order
PERSISTENT_FIELDS = ("phase", "dist", "trans", "sdx", "sdy", "sdz", "smax", "scx", "scy", "scz",
                     "dr", "dg", "db", "da", "acc", "samples")

LAUNCHES = {"frames": 0, "frames_majorant": 0, "frames_raw": 0, "frames_environment": 0,
            "persistent": 0, "persistent_majorant": 0, "persistent_raw": 0,
            "persistent_environment": 0, "persistent_streams": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _majorant_lookup(ctx, px, py, pz):
    """(m, r) of the majorant cell at normalized (px, py, pz): the local
    alpha majorant, floored at 1e-12, and the flight cap."""
    Gz, Gy, Gx, _ = ctx.majorant.shape
    cell = ((interp._nearest_coords(pz, Gz) * Gy + interp._nearest_coords(py, Gy)) * Gx
            + interp._nearest_coords(px, Gx))
    row = ctx.majorant.reshape(-1, 2)[cell.to(torch.int64)]
    return torch.clamp_min(row[..., 0], 1e-12), row[..., 1]


def _sample_tf(ctx, px, py, pz, volume_filter):
    return RK.sample_tf(ctx.density, ctx.tf_table, px, py, pz, volume_filter)


def _flight(rng, active, ctx, frm, to, dist, denom):
    """One masked free-flight draw: (rng, step, capped, m); in majorant
    mode at the local rate extinction * m from the cell at the lane's
    current distance, the step capped at the cell's flight range."""
    ext = K._f32(ctx.extinction)
    if ctx.majorant is None:
        rng, step = sampling.draw_exponential(rng, active, ext)
        return rng, step, torch.zeros_like(active), None
    m, cap = _majorant_lookup(ctx, *_mix3(frm, to, dist / denom))
    rng, step = sampling.draw_exponential(rng, active, m * ext)
    return rng, torch.minimum(step, cap), step >= cap, m


def _length(frm, to):
    ex, ey, ez = (to[i] - frm[i] for i in range(3))
    return torch.sqrt(ex * ex + ey * ey + ez * ez)


def _woodcock_distance(rng, ctx, frm, to, max_collisions, volume_filter):
    """sampleDistance: free flight until a real collision or an escape;
    returns (rng, dist, max_dist). A lane stops drawing once it is done;
    the loop ends when every lane is done or after ``max_collisions``
    iterations."""
    max_dist = _length(frm, to)
    denom = torch.clamp_min(max_dist, 1e-30)
    dist = torch.zeros_like(max_dist)
    done = torch.zeros(max_dist.shape, dtype=torch.bool, device=max_dist.device)
    i = 0
    while i < max_collisions and not bool(done.all()):
        active = ~done
        rng, step, capped, m = _flight(rng, active, ctx, frm, to, dist, denom)
        dist = torch.where(active, dist + step, dist)
        escaped = active & (dist > max_dist)
        still = active & ~escaped & ~capped
        tf4 = _sample_tf(ctx, *_mix3(frm, to, dist / denom), volume_filter)
        rng, u = sampling.draw(rng, still)
        alpha = tf4[..., 3]
        if m is not None:
            # delta tracking against the local majorant: accept with alpha / m
            alpha = torch.clamp_max(alpha / m, 1.0)
        done = done | escaped | (still & (u < alpha))
        i += 1
    return rng, dist, max_dist


def _woodcock_transmittance(rng, mask, ctx, frm, to, max_collisions, volume_filter):
    """sampleTransmittance: the product of (1 - alpha) over the tentative
    collisions to ``to`` (alpha / m against the majorant); lanes outside
    ``mask`` never run. Returns (rng, trans)."""
    max_dist = _length(frm, to)
    denom = torch.clamp_min(max_dist, 1e-30)
    dist = torch.zeros_like(max_dist)
    trans = torch.ones_like(max_dist)
    done = ~mask
    i = 0
    while i < max_collisions and not bool(done.all()):
        active = mask & ~done
        rng, step, capped, m = _flight(rng, active, ctx, frm, to, dist, denom)
        dist = torch.where(active, dist + step, dist)
        escaped = active & (dist > max_dist)
        still = active & ~escaped & ~capped
        alpha = _sample_tf(ctx, *_mix3(frm, to, dist / denom), volume_filter)[..., 3]
        if m is not None:
            alpha = torch.clamp_max(alpha / m, 1.0)
        trans = torch.where(still, trans * (1.0 - alpha), trans)
        done = done | escaped
        i += 1
    return rng, trans


def persistent_seeds(shape, seed_bits: int, device) -> torch.Tensor:
    """Each lane's chain seed over the lane shape (S, R, R): hash3(bits(u),
    bits(v), seed) of u = (ix + 0.5) / R and v = (iy + s R + 0.5) / R by IEEE
    division (as the kernels divide), so stream s seeds its rows as the rows
    of a taller framebuffer would."""
    streams, rows, res = shape
    if rows != res:
        raise ValueError(f"lane shape {tuple(shape)} is not (S, R, R)")

    def bits(n):
        i = torch.arange(n, dtype=torch.float32, device=device)
        return sampling.div_scalar(i + 0.5, float(res)).view(torch.int32).to(torch.int64)

    u = bits(res).view(1, 1, res).expand(streams, res, res)
    v = bits(streams * res).view(streams, res, 1).expand(streams, res, res)
    return sampling.hash3(u, v, torch.full_like(u, int(seed_bits) & sampling.MASK32))


def pixel_seeds(resolution: int, seed_bits: int, device) -> torch.Tensor:
    """Each pixel's chain seed, hash3(bits(u), bits(v), seed) of its screen
    uv: ``persistent_seeds`` of one stream."""
    return persistent_seeds((1, resolution, resolution), seed_bits, device)[0]


def _with_alpha(rgb):
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def mcs_frame(ctx, resolution: int, max_collisions: int = 1024, volume_filter: str = "linear"):
    """One single-scattering sample per pixel -> (R, R, 4) RGBA frame."""
    device = ctx.tf_table.device
    frm, to = camera_rays(resolution, ctx.inv_mvp, device)
    view = geometry.normalize3(*(to[i] - frm[i] for i in range(3)))
    tn, tf_, miss = ray_bounds(frm, to)
    entry, exit_ = _mix3(frm, to, tn), _mix3(frm, to, tf_)
    rng = pixel_seeds(resolution, ctx.seed_bits, device)
    rng, dist, max_dist = _woodcock_distance(rng, ctx, entry, exit_, max_collisions,
                                             volume_filter)
    escaped = dist > max_dist
    scat = _mix3(entry, exit_, dist / torch.clamp_min(max_dist, 1e-30))
    sd = torch.as_tensor(np.array(ctx.scatter_dir, np.float32), device=device)
    sdir = tuple(sd[i].expand(dist.shape) for i in range(3))
    _, stf = geometry.intersect_cube(*scat, *sdir)
    stf = torch.clamp_min(stf, 0.0)
    light_exit = tuple(scat[i] + sdir[i] * stf for i in range(3))
    diffuse = _sample_tf(ctx, *scat, volume_filter)
    # the light: one env sample at the frame's scattering direction, alpha 1
    light = _with_alpha(sample_environment(ctx.environment, sd[0], sd[1], sd[2]))
    rng, trans = _woodcock_transmittance(rng, ~miss & ~escaped, ctx, scat, light_exit,
                                         max_collisions, volume_filter)
    shaded = diffuse * light * trans[..., None]
    env = _with_alpha(sample_environment(ctx.environment, *view))
    return torch.where((miss | escaped)[..., None], env, shaded)


def frames_plain(acc, frame, ctx, seeds, scatter_dirs, max_collisions: int = 1024,
                 volume_filter: str = "linear"):
    """Plain ``frames``: for each (seed, scatter direction) one
    ``mcs_frame`` merged as acc + (img - acc) / frame; ``acc`` (R, R, 4)
    and ``frame`` (0-d int32) updated in place. Returns (acc, frame)."""
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    dirs = np.asarray(scatter_dirs, np.float32).reshape(-1, 3)
    out = acc.clone()
    for k, (seed, sd) in enumerate(zip(seeds, dirs)):
        c = dataclasses.replace(ctx, seed_bits=int(seed), scatter_dir=sd)
        img = mcs_frame(c, acc.shape[0], max_collisions, volume_filter)
        n = (frame + (k + 1)).to(torch.float32)
        out = out + (img - out) / n
    acc.copy_(out)
    frame.add_(len(seeds))
    return acc, frame


def mcs_frames(ctx, seeds, scatter_dirs, acc, frame, resolution: int, max_collisions: int = 1024,
               volume_filter: str = "linear"):
    """The JAX ``mcs_frames``: K frames folded into the running mean;
    returns new (acc, frame) and leaves its arguments as they were."""
    if tuple(acc.shape[:2]) != (resolution, resolution):
        raise ValueError(f"acc is {tuple(acc.shape)}, not ({resolution}, {resolution}, 4)")
    acc, frame = acc.clone(), frame.clone()
    return frames_plain(acc, frame, ctx, seeds, scatter_dirs, max_collisions, volume_filter)


def _lane_shape(resolution: int, streams: int):
    return (streams, resolution, resolution) if streams > 1 else (resolution, resolution)


def _mcs_persistent_dispatch_impl(state, ctx, resolution: int, steps: int, volume_filter: str,
                                  streams: int = 1, *, observe=None):
    """``steps`` persistent lane iterations from ``state`` (an
    ``MCSPersistentState``); returns the new state and leaves ``state`` as
    it was. ``observe``, when given, is called once per iteration with the
    iteration's lane values by name (``chip_smoke.py`` counts the work from
    them)."""
    device = ctx.tf_table.device
    lane_shape = _lane_shape(resolution, streams)
    frm, to = camera_rays(resolution, ctx.inv_mvp, device)
    view = geometry.normalize3(*(to[i] - frm[i] for i in range(3)))
    tn, tf_, miss = ray_bounds(frm, to)
    entry, exit_ = _mix3(frm, to, tn), _mix3(frm, to, tf_)
    # a ray that misses the cube gets max_dist 0: its first step escapes
    # and deposits the environment
    sx, sy, sz = (exit_[i] - entry[i] for i in range(3))
    max_dist = torch.where(miss, torch.zeros_like(tn), torch.sqrt(sx * sx + sy * sy + sz * sz))
    inv_md = torch.reciprocal(torch.clamp_min(max_dist, 1e-30))
    ray = tuple(a.expand(lane_shape) for a in (*entry, sx * inv_md, sy * inv_md, sz * inv_md,
                                                max_dist))
    env4 = _with_alpha(sample_environment(ctx.environment, *view)).expand(lane_shape + (4,))
    rng = persistent_seeds((streams, resolution, resolution), ctx.seed_bits,
                           device).reshape(lane_shape)
    ext = K._f32(ctx.extinction)
    every = torch.ones(lane_shape, dtype=torch.bool, device=device)
    p = state
    for _ in range(steps):
        shadow = p.phase
        # the segment: the camera ray (distance phase) or the shadow ray
        bx, by, bz, dx, dy, dz, seg_max = (
            torch.where(shadow, a, b) for a, b in zip(
                (p.scx, p.scy, p.scz, p.sdx, p.sdy, p.sdz, p.smax), ray))
        start = None
        if ctx.majorant is not None:
            start = (bx + dx * p.dist, by + dy * p.dist, bz + dz * p.dist)
            m, cap = _majorant_lookup(ctx, *start)
            rng, step = sampling.draw_exponential(rng, every, m * ext)
            capped = step >= cap
            step = torch.minimum(step, cap)
        else:
            m = torch.ones_like(p.dist)
            rng, step = sampling.draw_exponential(rng, every, ext)
            capped = torch.zeros_like(shadow)
        dist2 = p.dist + step
        escaped = dist2 > seg_max
        point = (bx + dx * dist2, by + dy * dist2, bz + dz * dist2)
        tf4 = _sample_tf(ctx, *point, volume_filter)
        alpha = torch.clamp_max(tf4[..., 3] / m, 1.0)
        tentative = ~escaped & ~capped
        # the acceptance draw in the distance phase only; the shadow phase
        # ratio-tracks every tentative collision
        rng, wheel = sampling.draw(rng, ~shadow)
        scatter = ~shadow & tentative & (wheel < alpha)
        rng, (nsx, nsy, nsz) = sampling.draw_sphere(rng, every)
        sfar = torch.clamp_min(geometry.intersect_cube(*point, nsx, nsy, nsz)[1], 0.0)
        # deposits: the environment on a distance-phase escape, the shaded
        # collision (the light at the sample's direction) on a shadow escape
        esc0 = ~shadow & escaped
        light = sample_environment(ctx.environment, p.sdx, p.sdy, p.sdz)
        shaded = torch.stack([p.dr * light[..., 0], p.dg * light[..., 1], p.db * light[..., 2],
                              p.da], dim=-1) * p.trans[..., None]
        deposit = escaped
        value = torch.where(esc0[..., None], env4, shaded)
        samples = p.samples + deposit.to(torch.int32)
        denom = torch.clamp_min(samples, 1).to(torch.float32)[..., None]
        acc = torch.where(deposit[..., None], p.acc + (value - p.acc) / denom, p.acc)
        if observe is not None:
            observe(dict(p=p, shadow=shadow, start=start, capped=capped, escaped=escaped,
                         point=point, tentative=tentative, scatter=scatter))
        # the next lane state
        trans = torch.where(shadow & tentative, p.trans * (1.0 - alpha), p.trans)
        restart = deposit | scatter
        sel = lambda a, b: torch.where(scatter, a, b)  # noqa: E731
        p = dataclasses.replace(
            p, phase=(shadow | scatter) & ~deposit,
            dist=torch.where(restart, torch.zeros_like(dist2), dist2),
            trans=torch.where(restart, torch.ones_like(trans), trans),
            sdx=sel(nsx, p.sdx), sdy=sel(nsy, p.sdy), sdz=sel(nsz, p.sdz), smax=sel(sfar, p.smax),
            scx=sel(point[0], p.scx), scy=sel(point[1], p.scy), scz=sel(point[2], p.scz),
            dr=sel(tf4[..., 0], p.dr), dg=sel(tf4[..., 1], p.dg), db=sel(tf4[..., 2], p.db),
            da=sel(tf4[..., 3], p.da), acc=acc, samples=samples)
    return p


mcs_persistent_dispatch = _mcs_persistent_dispatch_impl


def mcs_persistent_many(state, ctx, seeds, resolution: int, steps: int,
                        volume_filter: str = "linear", streams: int = 1, *, observe=None):
    """K dispatches, one per seed (the ctx's seed replaced); returns the new
    state and leaves ``state`` as it was."""
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        state = _mcs_persistent_dispatch_impl(
            state, dataclasses.replace(ctx, seed_bits=int(seed)), resolution, steps,
            volume_filter, streams, observe=observe)
    return state


def persistent_plain(state, ctx, seeds, steps: int, volume_filter: str = "linear",
                     streams: int = 1, *, observe=None):
    """Plain ``persistent``: ``mcs_persistent_many`` written into
    ``state``'s tensors in place. Returns ``state``."""
    out = mcs_persistent_many(state, ctx, seeds, state.dist.shape[-1], steps, volume_filter,
                              streams, observe=observe)
    for k in PERSISTENT_FIELDS:
        getattr(state, k).copy_(getattr(out, k))
    return state


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------
def persistent_mode(density, tf_table, volume_filter: str) -> str:
    """K22's and K23's instance for these tables (csrc/mcs.cu McsMode): "u8" / "f32"
    (a packed corner table, linear), "u8 quasicubic" / "f32 quasicubic",
    each beside the packed (Hp, Wp, 16) TF, or "nearest" (the raw (D, H, W)
    grid beside the raw (H, W, 4) TF), the pairs ``MCSRenderer`` builds; any
    other pair the wrappers take runs the "generic" instance, which reads
    the table kinds at run time."""
    tf_raw = tf_table.shape[-1] == 4
    if not isinstance(density, interp.PackedVolume):
        return "nearest" if volume_filter == "nearest" and tf_raw else "generic"
    if tf_raw or volume_filter not in ("linear", "quasicubic"):
        return "generic"
    kind = "u8" if density.table.dtype == torch.uint8 else "f32"
    return kind + (" quasicubic" if volume_filter == "quasicubic" else "")


def warp_tiles(resolution: int, device=None) -> torch.Tensor:
    """The pixels of each warp of K22 (and of K23's stream 0): csrc/mcs.cu
    ``mcsp_pixel``'s 8 x 4 pixel tile a warp, 16 x 8 a block, the blocks
    row-major over the tiles. (warps, 32) flat indices iy * R + ix in lane
    order, -1 where a lane lies outside the image."""
    tiles_x, tiles_y = -(-resolution // 16), -(-resolution // 8)
    block = torch.arange(tiles_x * tiles_y, device=device).view(-1, 1, 1)
    warp = torch.arange(4, device=device).view(1, -1, 1)
    lane = torch.arange(32, device=device).view(1, 1, -1)
    ix = (block % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7)
    iy = (block // tiles_x) * 8 + (warp >> 1) * 4 + (lane >> 3)
    inside = (ix < resolution) & (iy < resolution)
    return torch.where(inside, iy * resolution + ix, -1).view(-1, 32)


def _check_tables(ctx, volume_filter):
    if isinstance(ctx.density, interp.PackedVolume) and ctx.density.kind != "full":
        raise ValueError(f"mcs reads a full packed volume table, not {ctx.density.kind!r}")
    RK._check_tables(ctx.density, ctx.tf_table, volume_filter)
    env = ctx.environment
    if env.ndim != 3 or env.shape[-1] != 3:
        raise ValueError(f"environment must be a raw (He, We, 3) map, got {tuple(env.shape)}")
    K._check(env, "environment", torch.float32)
    if ctx.majorant is not None:
        if ctx.majorant.ndim != 4 or ctx.majorant.shape[-1] != 2:
            raise ValueError(f"majorant must be a (Gz, Gy, Gx, 2) table, got "
                             f"{tuple(ctx.majorant.shape)}")
        K._check(ctx.majorant, "majorant", torch.float32, align=8)


def _params(ctx, resolution: int, n_frames: int, max_collisions: int, volume_filter: str,
            steps: int = 0, streams: int = 1):
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(ctx.inv_mvp, np.float32).reshape(16)
    f[16] = ctx.extinction
    f[17] = np.float32(1.0 / resolution)
    vol, tf, env = ctx.density, ctx.tf_table, ctx.environment
    vol_raw = not isinstance(vol, interp.PackedVolume)
    # a raw axis of n texels is given as n + 1, as a packed table's would be
    dims = tuple(d + 1 for d in vol.shape) if vol_raw else vol.dims
    tf_raw = tf.shape[-1] == 4
    maj = tuple(ctx.majorant.shape[:3]) if ctx.majorant is not None else (0, 0, 0)
    i = np.array([
        resolution, n_frames, max_collisions, int(vol_raw),
        int(not vol_raw and vol.table.dtype == torch.uint8), *dims,
        int(volume_filter == "quasicubic"), int(volume_filter == "nearest"), int(tf_raw),
        tf.shape[0] + tf_raw, tf.shape[1] + tf_raw, env.shape[0], env.shape[1], *maj,
        steps, streams, PERSISTENT_MODES.index(persistent_mode(vol, tf, volume_filter)),
    ], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def _frame_inputs(seeds, dirs) -> np.ndarray:
    """The launch's per-frame inputs as one (K, 4) f32 array: the seed's
    bits, then the scattering direction."""
    out = np.empty((len(seeds), 4), np.float32)
    out[:, 0] = np.asarray(seeds, np.uint32).view(np.float32)
    out[:, 1:] = dirs
    return out


def frames(acc, frame, ctx, seeds, scatter_dirs, max_collisions: int = 1024,
           volume_filter: str = "linear"):
    """K frames, one per (seed, scatter direction), merged into the running
    mean ``acc`` (R, R, 4) in place; ``frame`` (0-d int32) advanced by K.
    On a CUDA device one launch of K22 ``mcs_frames`` (its instance for the
    tables' ``persistent_mode`` and the majorant; it reads the count) and
    the count's ``add_`` on the same stream."""
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    dirs = np.asarray(scatter_dirs, np.float32).reshape(-1, 3)
    if len(dirs) != len(seeds):
        raise ValueError(f"{len(seeds)} seeds but {len(dirs)} scatter directions")
    tensors = [acc, frame, RK._volume_tensor(ctx.density), ctx.tf_table, ctx.environment]
    if ctx.majorant is not None:
        tensors.append(ctx.majorant)
    if K._route(*tensors) == "cpu":
        return frames_plain(acc, frame, ctx, seeds, dirs, max_collisions, volume_filter)
    _check_tables(ctx, volume_filter)
    res = acc.shape[0]
    K._check(acc, "acc", torch.float32, (res, res, 4), align=16)
    K._check(frame, "frame", torch.int32, ())
    if len(seeds) == 0:
        return acc, frame
    f, i = _params(ctx, res, len(seeds), int(max_collisions), volume_filter)
    lib = _build.load()
    if (lib.vpt_mcs_layout(0), lib.vpt_mcs_layout(1)) != (_F_COUNT, _I_COUNT):
        raise RuntimeError("mcs kernel library parameter layout does not match the wrapper")
    device = acc.device
    inputs = torch.as_tensor(_frame_inputs(seeds, dirs), device=device)
    with torch.cuda.device(device):
        err = lib.vpt_mcs_frames(f.ctypes.data, i.ctypes.data, tensors[2].data_ptr(),
                                 ctx.tf_table.data_ptr(), ctx.environment.data_ptr(),
                                 K._ptr(ctx.majorant), inputs.data_ptr(), acc.data_ptr(),
                                 frame.data_ptr(), K._stream(device))
    K._raise_on(err, "mcs_frames")
    frame.add_(len(seeds))
    LAUNCHES["frames"] += 1
    for mode, on in (("majorant", ctx.majorant is not None),
                     ("raw", not isinstance(ctx.density, interp.PackedVolume)),
                     ("environment", ctx.environment.numel() > 3)):
        LAUNCHES[f"frames_{mode}"] += int(on)
    return acc, frame


def _check_persistent_state(state, streams: int):
    shape = tuple(state.dist.shape)
    if len(shape) not in (2, 3) or shape[-1] != shape[-2]:
        raise ValueError(f"the lane shape must be (R, R) or (S, R, R), got {shape}")
    if shape != _lane_shape(shape[-1], streams):
        raise ValueError(f"a lane shape {shape} is not that of {streams} stream(s)")
    for k in PERSISTENT_FIELDS:
        dtype = {"phase": torch.bool, "samples": torch.int32}.get(k, torch.float32)
        K._check(getattr(state, k), k, dtype, shape + (4,) if k == "acc" else shape,
                 align=16 if k == "acc" else 4)


def persistent(state, ctx, seeds, steps: int, volume_filter: str = "linear", streams: int = 1):
    """K dispatches of ``steps`` persistent-lane iterations, one per seed,
    updating ``state`` (an ``MCSPersistentState``) in place. On a CUDA device
    one launch of K23 ``mcs_persistent`` (its instance for the tables'
    ``persistent_mode``), which reads and writes each lane's fields once; the
    seeds are uploaded on the launch's stream."""
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    tensors = [getattr(state, k) for k in PERSISTENT_FIELDS] + [
        RK._volume_tensor(ctx.density), ctx.tf_table, ctx.environment]
    if ctx.majorant is not None:
        tensors.append(ctx.majorant)
    if K._route(*tensors) == "cpu":
        return persistent_plain(state, ctx, seeds, steps, volume_filter, streams)
    _check_tables(ctx, volume_filter)
    _check_persistent_state(state, streams)
    if len(seeds) == 0 or steps <= 0:
        return state
    res = state.dist.shape[-1]
    f, i = _params(ctx, res, len(seeds), 0, volume_filter, int(steps), int(streams))
    lib = _build.load()
    if (lib.vpt_mcs_layout(0), lib.vpt_mcs_layout(1)) != (_F_COUNT, _I_COUNT):
        raise RuntimeError("mcs kernel library parameter layout does not match the wrapper")
    device = state.dist.device
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    with torch.cuda.device(device):
        err = lib.vpt_mcs_persistent(
            f.ctypes.data, i.ctypes.data, tensors[len(PERSISTENT_FIELDS)].data_ptr(),
            ctx.tf_table.data_ptr(), ctx.environment.data_ptr(), K._ptr(ctx.majorant),
            seeds_dev.data_ptr(), *(getattr(state, k).data_ptr() for k in PERSISTENT_FIELDS),
            K._stream(device))
    K._raise_on(err, "mcs_persistent")
    LAUNCHES["persistent"] += 1
    for mode, on in (("majorant", ctx.majorant is not None),
                     ("raw", not isinstance(ctx.density, interp.PackedVolume)),
                     ("environment", ctx.environment.numel() > 3),
                     ("streams", streams > 1)):
        LAUNCHES[f"persistent_{mode}"] += int(on)
    return state
