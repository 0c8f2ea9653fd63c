"""Device-side splat renderer.

Counterpart of ``n_body_problem_tpu.render.splat``, in plain PyTorch on
either device. The reference hands the position buffer to OpenGL for
point-sprite rasterization with additive blending (``kernel.cu:1164-1176,
1245-1262``); here the frame is made on the device the bodies live on, in
the same three steps as the JAX package:

1. **Project**: scale by ``1 / (scale_factors + 1)``, apply the orbit
   camera's view-projection, perspective-divide, viewport transform
   (``vertex_shader.glsl`` + ``kernel.cu:1247-1258``).
2. **Scatter**: bilinear-deposit a unit impulse per body into one weight
   plane per point-size class (15 px for mass > 0.02, 10 px otherwise) with
   one ``index_put_(accumulate=True)`` of all four taps. Padding and unseen
   bodies are dropped before their coordinates become indices, and every
   tap outside the frame is dropped (GL clipping; only ``real_body_nums``
   drawn, ``kernel.cu:1261``).
3. **Convolve**: each plane with its class's precomputed ``intensity *
   alpha`` footprint, the two summed (one ``conv2d``, in the form that is
   faster on the device). Additive
   blending is linear, so scatter + convolve is the same sum as
   rasterizing every sprite.

The result is a float32 luminance accumulation times the golden sprite
color, the JAX package's (H, W, 3) frame. Nothing in it waits for the
host when the camera matrix and the scale factors come as tensors on the
bodies' device (``Simulation.movie`` passes them so); numpy arrays are
copied over on each call.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from n_body_problem_tpu_torch.render.camera import OrbitCamera
from n_body_problem_tpu_torch.render.sprites import (
    GOLDEN_COLOR,
    MASS_THRESHOLD,
    stacked_footprints,
)
from n_body_problem_tpu_torch.state import SimState


def project_to_screen(
    pos: torch.Tensor,              # (N, 3)
    view_projection,                # (4, 4)
    scale_factors,                  # (3,)
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (px, py, visible): window coords (y down) + frustum mask."""
    vp = torch.as_tensor(view_projection, dtype=torch.float32, device=pos.device)
    p = pos / (torch.as_tensor(scale_factors, dtype=torch.float32, device=pos.device) + 1.0)
    # [p, 1] @ vp.T in separate elementwise products and sums, in the order
    # XLA's CPU dot takes them ((x + y) + (z + w): the JAX package's clip
    # coordinates to the bit), the same on either device and never in TF32.
    clip = ((p[:, 0:1] * vp[:, 0] + p[:, 1:2] * vp[:, 1])
            + (p[:, 2:3] * vp[:, 2] + vp[:, 3]))                    # (N, 4)
    w = clip[:, 3]
    safe_w = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    ndc = clip[:, :3] / safe_w[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    visible = (
        (w > 0)
        & (ndc[:, 0] >= -1.1) & (ndc[:, 0] <= 1.1)
        & (ndc[:, 1] >= -1.1) & (ndc[:, 1] <= 1.1)
        & (ndc[:, 2] >= -1.0) & (ndc[:, 2] <= 1.0)
    )
    return px, py, visible


def _bilinear_scatter(px, py, draw, large, height: int, width: int) -> torch.Tensor:
    """Deposit each drawn body at (px, py) over its 4 neighbouring pixels of
    its class's plane (0: large, 1: small); returns (2, H, W).

    A body not drawn is moved to pixel (-10, -10) before the float-to-int
    cast: an unseen body's coordinates can reach 1e9 (``safe_w``), beyond
    int32. Every tap outside the frame, and every tap of a body not drawn,
    goes to a discard slot of its own body past the planes, so that no
    index wraps (negative) or overruns, and no one slot collects them all.
    The accumulation sorts its indices first: the sums are repeatable.
    """
    n = px.shape[0]
    off = torch.full_like(px, -10.0)
    px = torch.where(draw, px, off) - 0.5
    py = torch.where(draw, py, off) - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    # the taps (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
    ix = torch.stack([ix0, ix0 + 1, ix0, ix0 + 1])
    iy = torch.stack([iy0, iy0, iy0 + 1, iy0 + 1])
    wx = torch.stack([1.0 - fx, fx, 1.0 - fx, fx])
    wy = torch.stack([1.0 - fy, 1.0 - fy, fy, fy])
    plane = height * width
    inside = draw & (iy >= 0) & (iy < height) & (ix >= 0) & (ix < width)
    base = torch.where(large, 0, plane)
    discard = 2 * plane + torch.arange(n, device=px.device)
    idx = torch.where(inside, base + iy * width + ix, discard)
    flat = torch.zeros(2 * plane + n, dtype=torch.float32, device=px.device)
    flat.index_put_((idx.view(-1),), (wy * wx).view(-1), accumulate=True)
    return flat[: 2 * plane].view(2, height, width)


@functools.lru_cache(maxsize=None)
def _sprite_constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The footprints as depthwise weights (2, 1, S, S) and the golden
    color on ``device``, copied there once: a copy from pageable host
    memory would make the host wait for the device's stream every frame."""
    k = torch.from_numpy(stacked_footprints())[:, None].to(device)
    return k, torch.from_numpy(GOLDEN_COLOR).to(device)


def _conv_sprites(planes: torch.Tensor) -> torch.Tensor:
    """Convolve each impulse plane with its sprite footprint and sum the
    two: (H, W).

    ``conv2d`` is a cross-correlation, the JAX package's shift-and-FMA sum
    ``lum += k[dy, dx] * padded[dy:dy+H, dx:dx+W]``, so the footprints are
    not flipped (the 10 px sprite sits off-centre in the 15 px stack). The
    form is the faster one on the planes' device (``chip_smoke.py`` phase
    10 times both on both): on the card one depthwise convolution
    (``groups=2``) and a sum, since the 2-to-1 convolution's single output
    channel leaves cuDNN's GEMM nearly empty (8x slower on an H100 at
    1024x1024); on the CPU the 2-to-1 convolution, since PyTorch's CPU
    depthwise path is about 20x slower than it there (``--device cpu``
    movies and the CPU tests render with it). cuDNN takes TF32 for float32
    convolutions unless told not to; it is told so here, for this call
    only."""
    k = _sprite_constants(planes.device)[0]
    pad = k.shape[-1] // 2
    if not planes.is_cuda:
        return F.conv2d(planes[None], k.transpose(0, 1), padding=pad)[0, 0]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=True, allow_tf32=False):
        out = F.conv2d(planes[None], k, padding=pad, groups=2)[0]
    return out[0] + out[1]


def splat_frame(
    pos: torch.Tensor,
    mass: torch.Tensor,
    real_mask: torch.Tensor,
    view_projection,
    scale_factors,
    *,
    width: int = 1024,
    height: int = 768,
) -> torch.Tensor:
    """(H, W, 3) float32 additive frame (unclamped luminance * color), on
    ``pos``'s device."""
    px, py, visible = project_to_screen(pos, view_projection, scale_factors, width, height)
    planes = _bilinear_scatter(px, py, visible & real_mask, mass > MASS_THRESHOLD,
                               height, width)
    lum = _conv_sprites(planes)
    return lum[:, :, None] * _sprite_constants(pos.device)[1]


def render_state(
    state: SimState,
    camera: OrbitCamera,
    scale_factors=(0.0, 0.0, 0.0),
    *,
    width: int = 1024,
    height: int = 768,
) -> torch.Tensor:
    """Convenience wrapper: render a SimState with an OrbitCamera."""
    return splat_frame(
        state.pos,
        state.mass,
        state.real_mask(),
        camera.view_projection(),
        scale_factors,
        width=width,
        height=height,
    )
