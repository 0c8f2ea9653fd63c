"""``force_err_p99_fresh``: the 99th percentile, over the sampled bodies,
of the relative error of the treecode's force on acceptance lists built
fresh on the window's final state (``ops.registry.tree_fns`` of the run's
configuration, on the whole padded state as the program runs it), against
the plain reference's exact sum over the real bodies. Beside
``force_err_p99`` it tells the acceptance's error from the cadence's. It
copies the state and returns the work as a function, which the harness calls
once the program and its graphs' memory are freed: the fresh lists are as
large as the graphs' own, and at some millions of bodies both do not fit."""

import numpy as np
import torch

from nbody_bench import judge
from nbody_bench.metrics._common import is_tree
from nbody_bench.reference.gravity import accel


def read(trace, run):
    if not is_tree(run):
        return None
    from n_body_problem_tpu_torch.ops.registry import tree_fns

    sim = run.system.sim
    build, force = tree_fns(sim.cfg)
    pos, mass, n_real = sim.state.pos.clone(), sim.state.mass.clone(), sim.state.n_real
    rng = np.random.default_rng([run.seed % 2**64, 3])
    slots = torch.as_tensor(judge.sample_slots(run.n, run.cell.config["probe_bodies"], rng),
                            device=pos.device)
    ids = torch.as_tensor(np.asarray(sim.sort_perm), device=pos.device)
    m = torch.as_tensor(run.mass, dtype=torch.float64, device=pos.device)[ids]

    def fresh() -> float:
        with torch.no_grad():
            acc = force(pos, mass, build(pos, mass))
        x = pos[:n_real].double()
        ref = accel(x[slots], x, m, run.phys)
        err = (acc[slots].double() - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
        return float(np.percentile(err.cpu().numpy(), 99))

    return fresh
