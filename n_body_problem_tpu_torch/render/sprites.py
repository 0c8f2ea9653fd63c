"""Point-sprite footprints, precomputed from the fragment-shader math.

The reference splats each body as a golden radial-falloff disc
(``fragment_shader.glsl:5-19``): over the sprite square,
``dist = 2 * |pointCoord - 0.5|``, ``intensity = 1 - dist^2``, discarded
outside ``dist > 1``, blended additively with ``alpha = smoothstep(0.8,
0.1, dist)`` under ``glBlendFunc(GL_SRC_ALPHA, GL_ONE)``
(``kernel.cu:1177``). Additive blending is linear, so the whole raster
pass is exactly: scatter unit impulses at body pixels, then convolve with
this fixed ``intensity * alpha`` footprint — which is how the TPU renderer
turns millions of overlapping sprites into one MXU-friendly convolution.

Point size comes from the vertex shader: 15 px if mass > 0.02 else 10 px
(``vertex_shader.glsl:19-23``). The shader's second ``BrightColor`` output
has no attached render target in the reference (inert bloom leftover,
quirk Q7) and is deliberately not reproduced.
"""

from __future__ import annotations

import functools

import numpy as np

GOLDEN_COLOR = np.array([0.8667, 0.7, 0.2], dtype=np.float32)
SIZE_LARGE = 15       # mass > MASS_THRESHOLD
SIZE_SMALL = 10
MASS_THRESHOLD = 0.02


def _smoothstep_rev(edge0: float, edge1: float, x: np.ndarray) -> np.ndarray:
    # GLSL smoothstep with edge0 > edge1, as the reference calls it
    # (fragment_shader.glsl:16): a reversed 0->1 ramp.
    t = np.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@functools.lru_cache(maxsize=None)
def sprite_footprint(size: int) -> np.ndarray:
    """(size, size) f32 additive weight = intensity * alpha per pixel."""
    px = (np.arange(size, dtype=np.float32) + 0.5) / size  # pointCoord
    coord = px - 0.5
    cx, cy = np.meshgrid(coord, coord, indexing="xy")
    dist = 2.0 * np.sqrt(cx * cx + cy * cy)
    intensity = 1.0 - dist * dist
    alpha = _smoothstep_rev(0.8, 0.1, dist)
    w = intensity * alpha
    w[dist > 1.0] = 0.0
    return w.astype(np.float32)


def stacked_footprints(sizes: tuple[int, ...] = (SIZE_LARGE, SIZE_SMALL)) -> np.ndarray:
    """(len(sizes), S, S) kernels zero-padded to the largest size, for a
    single multi-channel convolution."""
    s_max = max(sizes)
    out = np.zeros((len(sizes), s_max, s_max), dtype=np.float32)
    for i, s in enumerate(sizes):
        k = sprite_footprint(s)
        o = (s_max - s) // 2
        out[i, o : o + s, o : o + s] = k
    return out
