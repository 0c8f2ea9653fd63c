"""Step-rate / throughput metrics logging.

The reference's only observability is a 100-frame moving-average frame time
posted to the window title (``kernel.cu:1269-1279``). This logger keeps the
same rolling-average idea but reports the numbers that matter for an
O(N^2) engine: ms/step, steps/s and directed pair interactions/s, plus
optional conserved-quantity drift.
"""

from __future__ import annotations

import dataclasses
import sys
import time


@dataclasses.dataclass
class StepTimer:
    """Rolling window of step timings (window=100 matches kernel.cu:1269).

    ``n_bodies`` should be the *real* (unpadded) body count: quoted pair
    throughput is physical directed pairs n(n-1), not the padded-N^2 rate.
    """

    n_bodies: int
    window: int = 100
    _t_last: float | None = None
    _acc_time: float = 0.0
    _acc_steps: int = 0
    total_steps: int = 0
    total_time: float = 0.0

    def start(self) -> None:
        self._t_last = time.perf_counter()

    def stop(self, steps: int) -> None:
        if self._t_last is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._t_last
        self._t_last = None
        self._acc_time += dt
        self._acc_steps += steps
        self.total_steps += steps
        self.total_time += dt

    @property
    def window_full(self) -> bool:
        return self._acc_steps >= self.window

    def snapshot(self, reset: bool = True) -> dict:
        steps = max(self._acc_steps, 1)
        ms = self._acc_time / steps * 1e3
        pairs = self.n_bodies * (self.n_bodies - 1) * steps / max(self._acc_time, 1e-12)
        out = {
            "ms_per_step": ms,
            "steps_per_sec": 1e3 / ms if ms > 0 else float("inf"),
            "pairs_per_sec": pairs,
            "steps": self.total_steps,
        }
        if reset:
            self._acc_time = 0.0
            self._acc_steps = 0
        return out

    def report(self, extra: str = "", file=sys.stderr) -> None:
        s = self.snapshot()
        print(
            f"[step {s['steps']:>8d}] {s['ms_per_step']:8.3f} ms/step  "
            f"{s['pairs_per_sec']:.3e} pairs/s{'  ' + extra if extra else ''}",
            file=file,
        )
