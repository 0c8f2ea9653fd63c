"""Offline converters (role of the reference's ``unused_files/tool.cpp``).

Counterpart of ``n_body_problem_tpu.io.convert``."""

from __future__ import annotations

import pathlib

import numpy as np

from n_body_problem_tpu_torch.io.tipsy import read_tipsy


def tipsy_to_csv(src: str | pathlib.Path, dst: str | pathlib.Path) -> int:
    """tipsy binary -> CSV with the same header/row layout as the
    reference's converter output (``tool.cpp:35-94`` /
    ``data/galaxy_20k.csv``): ``id,x,y,z,mass,vx,vy,vz,eps``.

    Returns the number of bodies written.
    """
    d = read_tipsy(src)
    cols = np.column_stack([
        d.pos[:, 0], d.pos[:, 1], d.pos[:, 2],
        d.mass,
        d.vel[:, 0], d.vel[:, 1], d.vel[:, 2],
        d.eps,
    ])
    with open(dst, "w") as f:
        f.write("id,x,y,z,mass,vx,vy,vz,eps\n")
        # id is the row index, as in the reference converter (tool.cpp:53,83),
        # not the tipsy phi field.
        for i, row in enumerate(cols):
            f.write(
                f"{i},{row[0]:g},{row[1]:g},{row[2]:g},{row[3]:g},"
                f"{row[4]:g},{row[5]:g},{row[6]:g},{row[7]:g}\n"
            )
    return len(d.ids)
