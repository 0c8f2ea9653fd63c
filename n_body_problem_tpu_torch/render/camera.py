"""Camera: perspective projection + spherical orbit controls.

Reproduces the reference's view pipeline in matrix form: positions are
divided by ``scale_factors + 1`` (``vertex_shader.glsl:11-14``), viewed
through ``lookAt(eye = spherical(theta, phi) * distance, target = origin,
up = +y)`` (``kernel.cu:1049-1064, 1251-1254``) and a 45-degree perspective
projection with near 0.1 / far 100 (``kernel.cu:1188``). Orbit controls
match the GLFW callbacks: drag sensitivity 0.1 deg/px with phi clamped to
+-89 degrees (``kernel.cu:1040-1047``), wheel zoom x1.1 / x0.9
(``kernel.cu:1016-1023``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def look_at(eye, target, up) -> np.ndarray:
    """Right-handed view matrix (4x4, row-vector convention M @ [p, 1])."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    t = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class OrbitCamera:
    """Spherical orbit camera around the origin (reference C19)."""

    theta_deg: float = 0.0
    phi_deg: float = 0.0
    distance: float = 1.0
    fov_deg: float = 45.0
    aspect: float = 4.0 / 3.0       # reference window 2400x1800
    near: float = 0.1
    far: float = 100.0
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)

    def eye(self) -> np.ndarray:
        th = math.radians(self.theta_deg)
        ph = math.radians(self.phi_deg)
        d = np.array(
            [math.cos(ph) * math.sin(th), math.sin(ph), math.cos(ph) * math.cos(th)],
            dtype=np.float32,
        )
        return d * self.distance

    def view(self) -> np.ndarray:
        return look_at(self.eye(), np.zeros(3), np.asarray(self.up))

    def projection(self) -> np.ndarray:
        return perspective(self.fov_deg, self.aspect, self.near, self.far)

    def view_projection(self) -> np.ndarray:
        return (self.projection() @ self.view()).astype(np.float32)

    # ------------------------------------------------------------ controls
    def orbit(self, dx_px: float, dy_px: float, sensitivity: float = 0.1) -> None:
        self.theta_deg -= dx_px * sensitivity
        self.phi_deg -= dy_px * sensitivity
        self.phi_deg = max(-89.0, min(89.0, self.phi_deg))

    def zoom(self, scroll: float) -> None:
        self.distance *= 1.1 if scroll < 0 else 0.9
