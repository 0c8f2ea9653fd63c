"""The live viewer's frame loop: ``Simulation.run(1)``, then one frame of
the new state (``render.splat.render_state``) copied into host memory, back
to back as the command line's ``--serve`` loop renders them, without the
socket. The reference integrates once a rendered frame
(``kernel.cu:1191-1282``). A frame is timed from the loop's request to the
frame in host memory. The host buffer is allocated once and reused, as a
viewer's frame buffer is: a fresh allocation a frame measures the host's
page faults."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from nbody_bench.snapshot import Call


class Loop:
    def __init__(self, system, traffic: dict):
        self.system, self.view = system, traffic["frame"]
        self.host = None

    def warm(self) -> Call:
        return self.call()

    def call(self) -> Call:
        t0 = time.perf_counter()
        with record_function("bench.run"):
            snap = self.system.run(1)
        with record_function("bench.frame"):
            frame = self.system.frame(self.view)
            if self.host is None:
                self.host = torch.empty(frame.shape, dtype=frame.dtype)
            self.host.copy_(frame)
        return Call(1, t0, time.perf_counter(), snap, self.host)
