"""Tipsy binary snapshot reader/writer.

Counterpart of ``n_body_problem_tpu.io.tipsy``, numpy for numpy. Layout
(cf. the reference structs at ``kernel.cu:103-128`` and reader at
``kernel.cu:190-303``):

- header, 32 bytes: double time; int32 nbodies, ndim, nsph, ndark, nstar;
  4 bytes struct padding.
- ndark x 36-byte dark records: f32 mass, pos[3], vel[3], eps; i32 phi.
- nstar x 44-byte star records: f32 mass, pos[3], vel[3], metals, tform,
  eps; i32 phi.

Field mapping matches the reference: mass rides with position (pos.w),
per-body eps rides with velocity (vel.w), phi becomes the body id
(``kernel.cu:224-246``). SPH records are not present in any shipped dataset
(nsph=0) and are rejected explicitly rather than mis-parsed.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state

_HEADER = np.dtype([
    ("time", "<f8"),
    ("nbodies", "<i4"),
    ("ndim", "<i4"),
    ("nsph", "<i4"),
    ("ndark", "<i4"),
    ("nstar", "<i4"),
    ("pad", "<i4"),
])

_DARK = np.dtype([
    ("mass", "<f4"),
    ("pos", "<f4", 3),
    ("vel", "<f4", 3),
    ("eps", "<f4"),
    ("phi", "<i4"),
])

_STAR = np.dtype([
    ("mass", "<f4"),
    ("pos", "<f4", 3),
    ("vel", "<f4", 3),
    ("metals", "<f4"),
    ("tform", "<f4"),
    ("eps", "<f4"),
    ("phi", "<i4"),
])


@dataclasses.dataclass
class TipsyData:
    time: float
    pos: np.ndarray    # (N, 3) f32
    vel: np.ndarray    # (N, 3) f32
    mass: np.ndarray   # (N,) f32
    eps: np.ndarray    # (N,) f32
    ids: np.ndarray    # (N,) i32 (phi)
    n_dark: int
    n_star: int

    def to_state(self) -> SimState:
        """A CPU ``SimState``; ``Simulation`` moves it to its device."""
        return make_state(self.pos, self.vel, self.mass, self.eps, time=self.time)


def read_tipsy(path: str | pathlib.Path, check_nan: bool = True) -> TipsyData:
    raw = pathlib.Path(path).read_bytes()
    if len(raw) < _HEADER.itemsize:
        raise ValueError(f"{path}: too short for a tipsy header")
    h = np.frombuffer(raw[: _HEADER.itemsize], dtype=_HEADER)[0]
    n_dark, n_star, n_sph = int(h["ndark"]), int(h["nstar"]), int(h["nsph"])
    if n_sph:
        raise NotImplementedError(f"{path}: SPH particles (nsph={n_sph}) unsupported")
    if int(h["nbodies"]) != n_dark + n_star:
        raise ValueError(
            f"{path}: nbodies={int(h['nbodies'])} != ndark+nstar={n_dark + n_star}"
        )
    expect = _HEADER.itemsize + n_dark * _DARK.itemsize + n_star * _STAR.itemsize
    if len(raw) != expect:
        raise ValueError(f"{path}: size {len(raw)} != expected {expect}")

    off = _HEADER.itemsize
    dark = np.frombuffer(raw, dtype=_DARK, count=n_dark, offset=off)
    off += n_dark * _DARK.itemsize
    star = np.frombuffer(raw, dtype=_STAR, count=n_star, offset=off)

    pos = np.concatenate([dark["pos"], star["pos"]]).astype(np.float32)
    vel = np.concatenate([dark["vel"], star["vel"]]).astype(np.float32)
    mass = np.concatenate([dark["mass"], star["mass"]]).astype(np.float32)
    eps = np.concatenate([dark["eps"], star["eps"]]).astype(np.float32)
    ids = np.concatenate([dark["phi"], star["phi"]]).astype(np.int32)
    if check_nan and not np.isfinite(pos).all():
        raise ValueError(f"{path}: NaN/inf positions")  # reference warns, kernel.cu:247
    return TipsyData(
        time=float(h["time"]), pos=pos, vel=vel, mass=mass, eps=eps, ids=ids,
        n_dark=n_dark, n_star=n_star,
    )


def write_tipsy(
    path: str | pathlib.Path,
    pos: np.ndarray,
    vel: np.ndarray,
    mass: np.ndarray,
    eps: np.ndarray | None = None,
    ids: np.ndarray | None = None,
    *,
    time: float = 0.0,
    n_dark: int = 0,
) -> None:
    """Write a tipsy binary: first ``n_dark`` bodies as dark, rest as star."""
    n = len(mass)
    if eps is None:
        eps = np.zeros(n, np.float32)
    if ids is None:
        ids = np.arange(n, dtype=np.int32)
    n_star = n - n_dark
    header = np.zeros(1, dtype=_HEADER)
    header["time"] = time
    header["nbodies"] = n
    header["ndim"] = 3
    header["nsph"] = 0
    header["ndark"] = n_dark
    header["nstar"] = n_star

    dark = np.zeros(n_dark, dtype=_DARK)
    star = np.zeros(n_star, dtype=_STAR)
    for rec, sl in ((dark, slice(0, n_dark)), (star, slice(n_dark, n))):
        rec["mass"] = mass[sl]
        rec["pos"] = pos[sl]
        rec["vel"] = vel[sl]
        rec["eps"] = eps[sl]
        rec["phi"] = ids[sl]
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(dark.tobytes())
        f.write(star.tobytes())
