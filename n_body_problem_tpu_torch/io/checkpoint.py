"""Checkpoint / resume, and export to the reference's snap format.

Counterpart of ``n_body_problem_tpu.io.checkpoint`` with the same ``.npz``
layout: the arrays of ``to_numpy`` plus a ``__meta__`` JSON string holding
the config. A checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.state import SimState, from_numpy, to_numpy, unpad_state


def save_checkpoint(
    path: str | pathlib.Path, state: SimState, cfg: SimConfig | None = None
) -> None:
    arrays = to_numpy(state)
    meta = {"config": cfg.to_dict() if cfg else None, "version": 1}
    np.savez_compressed(pathlib.Path(path), __meta__=json.dumps(meta), **arrays)


def load_checkpoint(
    path: str | pathlib.Path, device: str | torch.device | None = None,
) -> tuple[SimState, SimConfig | None]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        # acc restores the carried acceleration so leapfrog resumes seamlessly.
        state = from_numpy({k: z[k] for k in z.files if k != "__meta__"}, device)
    cfg = SimConfig.from_dict(meta["config"]) if meta.get("config") else None
    return state, cfg


def export_snap(path: str | pathlib.Path, state: SimState) -> None:
    """Write the reference-readable NEMO snap format (kernel.cu:433-544)
    of the real bodies."""
    from n_body_problem_tpu_torch.io.text import BodyData, write_snap

    s = unpad_state(state)
    write_snap(
        path,
        BodyData(
            pos=s.pos.cpu().numpy(), vel=s.vel.cpu().numpy(),
            mass=s.mass.cpu().numpy(), eps=s.eps.cpu().numpy(),
            time=float(s.time),
        ),
    )
