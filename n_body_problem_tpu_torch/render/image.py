"""Image finishing + PNG output (stdlib-only, no imaging deps)."""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import torch


def to_host(frame) -> np.ndarray:
    """A frame as a host array: a tensor (on any device) is copied off it,
    anything else goes through ``np.asarray``."""
    if isinstance(frame, torch.Tensor):
        return frame.detach().cpu().numpy()
    return np.asarray(frame)


def tonemap(frame, exposure: float = 1.0, background: float = 0.0) -> np.ndarray:
    """Additive HDR accumulation -> display range [0, 1] (GL clamps the
    framebuffer the same way after additive blending saturates)."""
    img = np.asarray(frame, dtype=np.float32) * exposure + background
    return np.clip(img, 0.0, 1.0)


def to_uint8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str | pathlib.Path, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 or float [0,1] as PNG via stdlib zlib."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected 3 channels, got {c}")

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    pathlib.Path(path).write_bytes(data)


def write_ppm(path: str | pathlib.Path, img: np.ndarray) -> None:
    if img.dtype != np.uint8:
        img = to_uint8(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(img.tobytes())
