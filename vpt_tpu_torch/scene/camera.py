"""Camera model and controllers.

The port's copy of vpt_tpu/scene/camera.py (numpy only).

Parity targets:
  - PerspectiveCamera: the reference's src/js/PerspectiveCamera.js:13-17
    (defaults fovy=1, aspect=1, near=0.1, far=100; camera node starts at
    translation [0,0,2], WebGPURenderingContext.js:36-37)
  - inverse-MVP build: WebGPUMCMSpectralComputeRenderer.js:262-274
    (model = translate(-0.5) centering the unit volume cube)
  - OrbitCameraAnimator yaw/pitch/zoom math: animators/OrbitCameraAnimator.js
  - CircleAnimator turntable path: animators/CircleAnimator.js
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vpt_tpu_torch.scene import transform as T


@dataclass
class Camera:
    """A perspective camera with a TRS pose; produces the inverse MVP that
    the ray-setup ops consume."""

    fovy: float = 1.0
    aspect: float = 1.0
    near: float = 0.1
    far: float = 100.0
    rotation: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    translation: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 2.0]))

    @property
    def projection_matrix(self) -> np.ndarray:
        return T.perspective(self.fovy, self.aspect, self.near, self.far)

    @property
    def view_matrix(self) -> np.ndarray:
        return np.linalg.inv(T.trs(self.rotation, self.translation, np.ones(3)))

    def inverse_mvp(self, model_matrix: np.ndarray | None = None) -> np.ndarray:
        """inv(P @ V @ M) as float32; M defaults to translate(-0.5) — the unit
        volume cube centered at the origin."""
        if model_matrix is None:
            model_matrix = T.translate([-0.5, -0.5, -0.5])
        mvp = self.projection_matrix @ self.view_matrix @ model_matrix
        return np.linalg.inv(mvp).astype(np.float32)


@dataclass
class OrbitController:
    """Yaw/pitch orbit around a focus point (OrbitCameraAnimator semantics).

    ``apply(camera)`` writes the orbit pose into the camera. All angles in
    radians; zoom is exponential in the scroll amount.
    """

    focus: np.ndarray = field(default_factory=lambda: np.zeros(3))
    focus_distance: float = 2.0
    yaw: float = 0.0
    pitch: float = 0.0

    def rotate(self, d_yaw: float, d_pitch: float):
        half_pi = np.pi / 2
        self.pitch = float(np.clip(self.pitch + d_pitch, -half_pi, half_pi))
        self.yaw = float((self.yaw + d_yaw) % (2 * np.pi))

    def zoom(self, amount: float):
        self.focus_distance *= float(np.exp(amount))

    def move(self, v):
        q = self._rotation_quat()
        self.focus = self.focus + T.quat_apply(q, v)

    def _rotation_quat(self):
        q = np.array([0.0, 0.0, 0.0, 1.0])
        q = T.quat_rotate_y(q, self.yaw)
        q = T.quat_rotate_x(q, self.pitch)
        return q

    def apply(self, camera: Camera) -> Camera:
        q = self._rotation_quat()
        camera.rotation = q
        camera.translation = self.focus + T.quat_apply(q, [0.0, 0.0, self.focus_distance])
        return camera


@dataclass
class CircleAnimator:
    """Parametric circular camera path for turntable renders."""

    center: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 2.0]))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    radius: float = 1.0
    frequency: float = 1.0

    def pose_at(self, t: float):
        """Return (rotation_quat, translation) at time ``t``."""
        to = self.direction / np.linalg.norm(self.direction)
        frm = np.array([0.0, 0.0, 1.0])
        axis = np.cross(frm, to)
        q = np.array([*axis, float(np.dot(frm, to))])

        angle = self.frequency * t * 2 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        # rotate [1,0,0] about z by angle, scale by radius, orient, translate
        local = np.array([c, s, 0.0]) * self.radius
        pos = self.center + T.quat_apply(q, local)
        return q, pos

    def apply(self, camera: Camera, t: float) -> Camera:
        q, pos = self.pose_at(t)
        camera.rotation = q
        camera.translation = pos
        return camera
