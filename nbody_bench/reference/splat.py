"""The plain reference of a rendered frame: the orbit camera, the point
sprites and their additive splat, in plain PyTorch and NumPy.

Frozen copies of the plain formulas of ``n_body_problem_tpu_torch/render/
camera.py``, ``sprites.py`` and ``splat.py`` at commit
c8a9ef2832dd3ca6223213d0b57046ed74f6d186, which follow the reference's
shaders (``vertex_shader.glsl``, ``fragment_shader.glsl``, ``kernel.cu:
1164-1188, 1245-1262``): positions divided by ``scale + 1``, a look-at view
and a 45-degree perspective, and each body's sprite (15 px above mass 0.02,
10 px otherwise, ``intensity * alpha`` over the sprite square) added into a
luminance plane, times the golden colour. Additive blending is linear, so
the sprites are the bilinear impulses of the bodies convolved with the
footprints. The matrices are worked out here in float64, the image in the
``dtype`` given. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GOLDEN_COLOR = (0.8667, 0.7, 0.2)
SIZES = (15, 10)          # the large sprite first, as the planes are stacked
MASS_THRESHOLD = 0.02


def view_projection(theta_deg: float, phi_deg: float, distance: float, aspect: float,
                    fov_deg: float = 45.0, near: float = 0.1, far: float = 100.0) -> np.ndarray:
    """(4, 4) float64 perspective times look-at from the orbit camera's
    spherical position towards the origin, +y up."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    eye = distance * np.array([math.cos(ph) * math.sin(th), math.sin(ph),
                               math.cos(ph) * math.cos(th)])
    f = -eye / np.linalg.norm(eye)
    s = np.cross(f, [0.0, 1.0, 0.0])
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -s @ eye, -u @ eye, f @ eye
    t = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = t / aspect, t
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = 2.0 * far * near / (near - far)
    proj[3, 2] = -1.0
    return proj @ view


def footprint(size: int) -> np.ndarray:
    """(size, size) ``intensity * alpha`` of the fragment shader: over the
    sprite square ``dist = 2 |coord - 0.5|``, ``1 - dist^2`` times the
    reversed ``smoothstep(0.8, 0.1, dist)``, nothing beyond ``dist = 1``."""
    c = (np.arange(size) + 0.5) / size - 0.5
    cx, cy = np.meshgrid(c, c, indexing="xy")
    dist = 2.0 * np.sqrt(cx * cx + cy * cy)
    t = np.clip((dist - 0.8) / (0.1 - 0.8), 0.0, 1.0)
    w = (1.0 - dist * dist) * (t * t * (3.0 - 2.0 * t))
    return np.where(dist > 1.0, 0.0, w)


def footprints() -> np.ndarray:
    """(2, 15, 15): both footprints centred in the larger square."""
    out = np.zeros((2, SIZES[0], SIZES[0]))
    for i, s in enumerate(SIZES):
        o = (SIZES[0] - s) // 2
        out[i, o:o + s, o:o + s] = footprint(s)
    return out


def frame(pos: torch.Tensor, mass: torch.Tensor, vp: np.ndarray, scale=(0.0, 0.0, 0.0), *,
          width: int, height: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(height, width, 3) additive frame of the bodies ``pos`` (N, 3), on
    ``pos``'s device, computed in ``dtype``."""
    dev = pos.device
    p = pos.to(dtype) / (torch.tensor(scale, dtype=dtype, device=dev) + 1.0)
    m = torch.as_tensor(vp, dtype=dtype, device=dev)
    clip = p @ m[:, :3].T + m[:, 3]
    w = clip[:, 3]
    w_safe = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    ndc = clip[:, :3] / w_safe[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    seen = ((w > 0) & (ndc[:, 0].abs() <= 1.1) & (ndc[:, 1].abs() <= 1.1)
            & (ndc[:, 2].abs() <= 1.0))
    px, py = px[seen] - 0.5, py[seen] - 0.5
    plane = torch.where(mass[seen] > MASS_THRESHOLD, 0, 1)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    img = torch.zeros((2, height, width), dtype=dtype, device=dev)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            x, y = x0 + dx, y0 + dy
            inside = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            img.index_put_((plane[inside], y[inside], x[inside]), (wy * wx)[inside],
                           accumulate=True)
    k = torch.as_tensor(footprints(), dtype=dtype, device=dev)[:, None]
    lum = F.conv2d(img[None], k, padding=SIZES[0] // 2, groups=2)[0].sum(0)
    return lum[:, :, None] * torch.tensor(GOLDEN_COLOR, dtype=dtype, device=dev)
