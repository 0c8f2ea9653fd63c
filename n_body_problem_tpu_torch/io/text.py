"""ASCII dataset formats: tab, dat, NEMO snap, and the converter's CSV.

Counterpart of ``n_body_problem_tpu.io.text``, numpy for numpy. Column
conventions follow the reference loaders exactly:

- **tab** (``readTabFile``, ``kernel.cu:305-354``): one body per line,
  ``mass x y z vx vy vz``. The reference's ``while(!eof)`` loop parses one
  extra line after the last newline, appending a duplicate of the final
  body (quirk Q3); ``quirk_trailing_body=True`` reproduces that.
- **dat** (``readDatFile``, ``kernel.cu:368-420``): ``z y x vz vy vx`` per
  line (note the reversed axis order), unit mass, blank lines skipped — the
  blank-skip is also why dat avoids the tab quirk.
- **snap** (``readSnapFile``, ``kernel.cu:433-544``): NEMO-style ASCII —
  three header lines (nbodies, ndim, time), then N mass lines, N position
  rows, N velocity rows, N per-body softening lines.

All readers return host numpy in float32 (the reference's ``real``), plus a
``to_state`` conversion to a CPU ``SimState``. When the C++ loader library
builds (``native/nbody_io.cpp``, :mod:`~n_body_problem_tpu_torch.io.native`)
the line parsing runs there; these numpy implementations are the
always-available fallback and the correctness oracle for it.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from n_body_problem_tpu_torch.io import native
from n_body_problem_tpu_torch.state import SimState, make_state


@dataclasses.dataclass
class BodyData:
    pos: np.ndarray
    vel: np.ndarray
    mass: np.ndarray
    eps: np.ndarray
    time: float = 0.0

    @property
    def n(self) -> int:
        return len(self.mass)

    def to_state(self) -> SimState:
        """A CPU ``SimState``; ``Simulation`` moves it to its device."""
        return make_state(self.pos, self.vel, self.mass, self.eps, time=self.time)


def _parse_columns(path: str | pathlib.Path, n_cols: int, skip_blank: bool) -> np.ndarray:
    arr = native.parse_table(path, n_cols, skip_blank=skip_blank)
    if arr is not None:
        return arr
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts and skip_blank:
                continue
            vals = [float(p) for p in parts[:n_cols]]
            vals += [0.0] * (n_cols - len(vals))
            rows.append(vals)
    return np.asarray(rows, dtype=np.float32).reshape(-1, n_cols)


def read_tab(path: str | pathlib.Path, quirk_trailing_body: bool = False) -> BodyData:
    a = _parse_columns(path, 7, skip_blank=True)
    if quirk_trailing_body and len(a):
        a = np.concatenate([a, a[-1:]])  # Q3: eof re-parse duplicates the last body
    return BodyData(
        pos=a[:, 1:4].copy(),
        vel=a[:, 4:7].copy(),
        mass=a[:, 0].copy(),
        eps=np.zeros(len(a), np.float32),
    )


def read_dat(path: str | pathlib.Path) -> BodyData:
    a = _parse_columns(path, 6, skip_blank=True)
    # Columns are z y x vz vy vx -> flip to x y z.
    return BodyData(
        pos=a[:, [2, 1, 0]].copy(),
        vel=a[:, [5, 4, 3]].copy(),
        mass=np.ones(len(a), np.float32),
        eps=np.zeros(len(a), np.float32),
    )


def read_snap(path: str | pathlib.Path) -> BodyData:
    with open(path) as f:
        n = int(f.readline().split()[0])
        ndim = int(f.readline().split()[0])
        time = float(f.readline().split()[0])
        if ndim != 3:
            raise ValueError(f"{path}: ndim={ndim}, only 3 supported")
        # Sections have different column counts (1 / 3 / 3 / 1), so consume
        # the token stream rather than line-shaped loadtxt.
        tokens = native.parse_tokens(path, skip_lines=3)
        if tokens is None:
            tokens = np.array(f.read().split(), dtype=np.float64)
    need = n + 3 * n + 3 * n + n
    if len(tokens) < need:
        raise ValueError(f"{path}: truncated snap file ({len(tokens)} < {need} values)")
    mass = tokens[:n].astype(np.float32)
    pos = tokens[n:4 * n].reshape(n, 3).astype(np.float32)
    vel = tokens[4 * n:7 * n].reshape(n, 3).astype(np.float32)
    eps = tokens[7 * n:8 * n].astype(np.float32)
    return BodyData(pos=pos, vel=vel, mass=mass, eps=eps, time=time)


def read_csv(path: str | pathlib.Path) -> BodyData:
    """Read the converter's CSV format (``id,x,y,z,mass,vx,vy,vz,eps``, the
    layout of the reference-shipped ``galaxy_20k.csv`` produced by
    ``tool.cpp``). Round-trips with
    :func:`~n_body_problem_tpu_torch.io.convert.tipsy_to_csv`."""
    a = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
    a = a.reshape(-1, 9)
    return BodyData(
        pos=a[:, 1:4].astype(np.float32),
        vel=a[:, 5:8].astype(np.float32),
        mass=a[:, 4].astype(np.float32),
        eps=a[:, 8].astype(np.float32),
    )


def read_snap_as_dat(path: str | pathlib.Path) -> BodyData:
    """Quirk Q1: the reference routes datasets 4/5 (.snap files) through the
    dat reader (``kernel.cu:1002, 1008``), so the 3 header lines become 3
    bogus bodies and every body gets unit mass with z/y/x column order.
    Provided for bug-for-bug parity runs only."""
    return read_dat(path)


def write_tab(path: str | pathlib.Path, data: BodyData) -> None:
    a = np.concatenate([data.mass[:, None], data.pos, data.vel], axis=1)
    np.savetxt(path, a, fmt="%.7g")


def write_snap(path: str | pathlib.Path, data: BodyData) -> None:
    n = data.n
    with open(path, "w") as f:
        f.write(f"{n}\n3\n{data.time!r}\n")
        np.savetxt(f, data.mass, fmt="%.7g")
        np.savetxt(f, data.pos, fmt="%.7g")
        np.savetxt(f, data.vel, fmt="%.7g")
        np.savetxt(f, data.eps, fmt="%.7g")
