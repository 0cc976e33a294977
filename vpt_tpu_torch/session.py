"""RenderSession — the host-side rendering runtime (counterpart of
``vpt_tpu/session.py``): renderer and tonemapper lifecycle, the
reset-on-camera-change contract, the progressive frame loop with
deterministic per-frame seeds, metrics, and checkpoint/resume of the
accumulation state.

Checkpoints keep the JAX package's format (``leaf_i`` arrays in the order
``jax.tree.flatten`` gives the state: the ``SpectralState`` fields, or a
dict state's values by sorted key), so a checkpoint written by either
package loads into the other's session for the same renderer. A host-scalar
leaf (an ``int`` or ``float``, e.g. DOS's sweep depth) is written as the
0-d array ``np.asarray`` gives and restored as its own Python type, as
the JAX session does.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from vpt_tpu_torch.scene.camera import Camera
from vpt_tpu_torch.models import make_renderer
from vpt_tpu_torch.postprocess.tonemap import make_tonemapper

log = logging.getLogger("vpt_tpu_torch.session")


def state_leaves(state) -> list:
    """The state's leaves in the JAX package's leaf order: a dict state's
    values by sorted key (the ray-march renderers; tensors and host
    scalars), else ``tensors()``."""
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return state.tensors()


def state_from_leaves(template, leaves):
    """A state of ``template``'s structure holding ``leaves``."""
    if isinstance(template, dict):
        return dict(zip(sorted(template), leaves))
    return type(template)(*leaves)


def frame_seed(base_seed: int, frame: int) -> int:
    """Deterministic per-frame seed (replaces the reference's Math.random())."""
    h = hashlib.blake2s(f"{base_seed}:{frame}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


class RenderSession:
    """Progressive rendering session over one renderer + tonemapper.

    ``device`` is where the scene tables and the photon state live; it is
    always given explicitly."""

    def __init__(
        self,
        renderer_key: str,
        *renderer_args,
        device,
        tonemapper: str = "artistic",
        tonemapper_kw: Optional[dict] = None,
        camera: Optional[Camera] = None,
        base_seed: int = 0,
        **renderer_kw,
    ):
        self.renderer_key = renderer_key
        self.device = torch.device(device)
        self.renderer = make_renderer(renderer_key, *renderer_args, device=self.device,
                                      **renderer_kw)
        self.tonemapper_key = tonemapper
        self.tonemapper = make_tonemapper(tonemapper, **(tonemapper_kw or {}))
        self.camera = camera or Camera()
        self.base_seed = base_seed
        self.frame = 0
        self.state = None
        self.hdr = None
        self._t_total = 0.0
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Restart accumulation (any camera/config change calls this)."""
        self.frame = 0
        self.state = self.renderer.reset(self.camera, frame_seed(self.base_seed, 0))
        self.hdr = None
        log.debug("session reset (renderer=%s)", self.renderer_key)

    def choose_tonemapper(self, key: str, **kw):
        self.tonemapper_key = key
        self.tonemapper = make_tonemapper(key, **kw)

    def set_camera(self, camera: Camera):
        self.camera = camera
        self.reset()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the frame loop ----------------------------------------------------
    def run(self, frames: int = 1, progress: Optional[Callable] = None):
        """Dispatch ``frames`` progressive render passes: one batched
        ``render_many`` (one kernel launch on the GPU) when the renderer has
        one and no per-frame progress is requested, identical to the
        sequential path; else one ``render`` per frame."""
        t0 = time.perf_counter()
        many = getattr(self.renderer, "render_many", None)
        if many is not None and progress is None and frames > 1:
            seeds = [frame_seed(self.base_seed, self.frame + 1 + k) for k in range(frames)]
            self.frame += frames
            self.state, self.hdr = many(self.state, self.camera, seeds)
        else:
            for _ in range(frames):
                self.frame += 1
                seed = frame_seed(self.base_seed, self.frame)
                self.state, self.hdr = self.renderer.render(self.state, self.camera, seed)
                if progress is not None:
                    progress(self.frame)
        self._sync()
        self._t_total += time.perf_counter() - t0
        return self

    # -- outputs -----------------------------------------------------------
    def hdr_image(self) -> np.ndarray:
        if self.hdr is None:
            raise RuntimeError("run() at least one frame first")
        return self.hdr.cpu().numpy()

    def image(self) -> np.ndarray:
        """Tone-mapped display image in [0,1]."""
        if self.hdr is None:
            raise RuntimeError("run() at least one frame first")
        return self.tonemapper(self.hdr).cpu().numpy()

    def image_u8(self) -> np.ndarray:
        return (np.clip(self.image(), 0, 1) * 255).astype(np.uint8)

    def metrics(self) -> dict:
        out = {"frames": self.frame, "seconds": self._t_total}
        s = getattr(self.state, "samples", None)
        if s is not None:
            out["spp_mean"] = float(s.to(torch.float64).mean())
            out["paths"] = int(s.to(torch.int64).sum())
            if self._t_total > 0:
                out["paths_per_s"] = out["paths"] / self._t_total
        return out

    # -- animation recording ----------------------------------------------
    def record_animation(self, animator, n_frames: int, frames_per_pose: int = 16,
                         start_time: float = 0.0, duration: float = 1.0,
                         progress: Optional[Callable] = None):
        """Per pose: animator.apply(camera, t) -> reset -> accumulate
        ``frames_per_pose`` dispatches -> tonemap; returns uint8 images."""
        images = []
        for i in range(n_frames):
            t = start_time + duration * (i / max(n_frames - 1, 1))
            animator.apply(self.camera, t)
            self.reset()
            self.run(frames_per_pose)
            images.append(self.image_u8())
            if progress is not None:
                progress((i + 1) / n_frames)
        return images

    # -- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, path: str):
        """Snapshot the accumulation state (resumable progressive render)."""
        leaves = [t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
                  for t in state_leaves(self.state)]
        np.savez(
            path,
            frame=self.frame,
            base_seed=self.base_seed,
            renderer_key=self.renderer_key,
            n_leaves=len(leaves),
            **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
        )

    def load_checkpoint(self, path: str):
        """Restore a checkpoint written by this package or by ``vpt_tpu``."""
        data = np.load(path, allow_pickle=False)
        if str(data["renderer_key"]) != self.renderer_key:
            raise ValueError(f"checkpoint was for renderer {data['renderer_key']}, "
                             f"session uses {self.renderer_key}")
        template = state_leaves(self.state)
        if int(data["n_leaves"]) != len(template):
            raise ValueError("checkpoint structure mismatch")
        leaves = []
        for i, old in enumerate(template):
            saved = data[f"leaf_{i}"]
            if isinstance(old, (int, float)):  # a host-scalar leaf (DOS's depth)
                leaves.append(type(old)(saved))
                continue
            want = (tuple(old.shape), str(old.dtype).replace("torch.", ""))
            if (saved.shape, str(saved.dtype)) != want:
                raise ValueError(f"leaf {i} mismatch: {saved.shape}/{saved.dtype} vs {want}")
            leaves.append(torch.as_tensor(saved, device=old.device))
        self.state = state_from_leaves(self.state, leaves)
        self.frame = int(data["frame"])
        self.base_seed = int(data["base_seed"])
        return self
