"""What a call of a system under test hands back, and what a loop records."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Snapshot:
    """The state a call returned: positions, velocities and the force of
    its last step, (N, 3) each on the device, N the configuration's real
    bodies (no padding), in the system's slot order;
    ``ids[i]`` is the input index of the body at slot i (None: slot i holds
    body i); ``step`` the system's own count of the steps it has taken (a
    0-d tensor or an int, read only once the window has closed)."""
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    ids: np.ndarray | None = None
    step: torch.Tensor | int = 0

    def input_ids(self) -> np.ndarray:
        n = self.pos.shape[0]
        return np.arange(n) if self.ids is None else np.asarray(self.ids)


@dataclasses.dataclass
class Call:
    """One iteration of a loop: the steps it took, when the loop asked for
    it and when its result was in host memory (host clock, seconds), the
    state it returned and, where the loop renders, the frame (H, W, 3) on
    the host."""
    steps: int
    start: float
    end: float
    snap: Snapshot
    frame: torch.Tensor | None = None
