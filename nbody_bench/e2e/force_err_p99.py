"""``force_err_p99``: the 99th percentile, over the sampled bodies, of the
relative error of the force of the warm call's last step (the state's
``acc``: a treecode cell's force on the run's own acceptance lists, as stale
as the call's last chunk makes them) against the plain reference's exact
sum: the comparison's ``force_p99`` of that call. The warm call is the
loop's own call, the same number of steps from the seed's bodies in every
run, so the reading does not hang on how many calls the window held: the
tail of a state many calls on swings by a third from state to state."""


def read(run) -> float | None:
    return run.warm_numbers.get("force_p99")
