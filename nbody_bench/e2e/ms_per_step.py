"""``ms_per_step``: the window's wall time over all the steps its calls took
(in the live loop a step is a frame, and the steps are the system's own
count), host clock to a synchronize. It also reads ``ms_per_step.host_paced``,
the same in the cells whose pace the host sets: their runs spread by 5-7 %,
thirty times the device-bound cells', so they carry a bound of their own."""


def read(run) -> float | None:
    return run.window_s / run.steps * 1e3 if run.steps > 0 else None
