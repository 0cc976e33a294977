"""Minimal scene graph: nodes with quaternion TRS transforms.

The port's copy of vpt_tpu/scene/transform.py (numpy only).

Behavioral parity: the reference's src/js/Node.js, Transform.js (quat TRS ->
localMatrix, recursive global/inverse-global matrices). Host-side numpy — the
scene graph only ever produces one (4,4) matrix per render step.

Matrices are in mathematical row-major convention: ``m @ [x,y,z,1]``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def quat_to_mat3(q) -> np.ndarray:
    """Unit quaternion [x,y,z,w] -> (3,3) rotation matrix."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def quat_rotate_y(q, rad):
    half = rad * 0.5
    return quat_mul(q, np.array([0.0, np.sin(half), 0.0, np.cos(half)]))


def quat_rotate_x(q, rad):
    half = rad * 0.5
    return quat_mul(q, np.array([np.sin(half), 0.0, 0.0, np.cos(half)]))


def quat_apply(q, v):
    return quat_to_mat3(q) @ np.asarray(v, np.float64)


def trs(rotation, translation, scale) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_mat3(rotation) * np.asarray(scale, np.float64)
    m[:3, 3] = translation
    return m


def translate(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """WebGL-convention perspective projection (gl-matrix mat4.perspective)."""
    f = 1.0 / np.tan(fovy / 2.0)
    nf = 1.0 / (near - far)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) * nf
    m[2, 3] = 2.0 * far * near * nf
    m[3, 2] = -1.0
    return m


class Transform:
    """Quaternion TRS transform component; fires change callbacks on set."""

    def __init__(self, node: "Node"):
        self.node = node
        self._rotation = np.array([0.0, 0.0, 0.0, 1.0])
        self._translation = np.zeros(3)
        self._scale = np.ones(3)
        self.change_listeners: List[Callable[[], None]] = []

    # -- accessors ---------------------------------------------------------
    @property
    def local_rotation(self):
        return self._rotation.copy()

    @local_rotation.setter
    def local_rotation(self, q):
        self._rotation = np.asarray(q, np.float64).copy()
        self._fire()

    @property
    def local_translation(self):
        return self._translation.copy()

    @local_translation.setter
    def local_translation(self, t):
        self._translation = np.asarray(t, np.float64).copy()
        self._fire()

    @property
    def local_scale(self):
        return self._scale.copy()

    @local_scale.setter
    def local_scale(self, s):
        self._scale = np.asarray(s, np.float64).copy()
        self._fire()

    # -- matrices ----------------------------------------------------------
    @property
    def local_matrix(self) -> np.ndarray:
        return trs(self._rotation, self._translation, self._scale)

    @property
    def global_matrix(self) -> np.ndarray:
        if self.node is not None and self.node.parent is not None:
            return self.node.parent.transform.global_matrix @ self.local_matrix
        return self.local_matrix

    @property
    def inverse_global_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.global_matrix)

    def _fire(self):
        for cb in self.change_listeners:
            cb()


class Node:
    """Scene-graph node holding a Transform and arbitrary components."""

    def __init__(self, parent: Optional["Node"] = None):
        self.parent = parent
        self.children: List[Node] = []
        if parent is not None:
            parent.children.append(self)
        self.transform = Transform(self)
        self.components: list = []

    def add_component(self, component):
        self.components.append(component)
        return component

    def get_component(self, cls):
        for c in self.components:
            if isinstance(c, cls):
                return c
        return None
