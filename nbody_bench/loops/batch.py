"""The command line's batch loop: ``Simulation.run(steps_per_call)`` back to
back (``--steps-per-block``), no frames, a closed loop: the next call starts
when the last has returned, which is when the device has finished it."""

from __future__ import annotations

import time

from torch.profiler import record_function

from nbody_bench.snapshot import Call


class Loop:
    def __init__(self, system, traffic: dict):
        self.system, self.steps = system, traffic["steps_per_call"]

    def warm(self) -> Call:
        return self.call()

    def call(self) -> Call:
        t0 = time.perf_counter()
        with record_function("bench.run"):
            snap = self.system.run(self.steps)
        return Call(self.steps, t0, time.perf_counter(), snap)
