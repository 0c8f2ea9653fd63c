"""``force_err_p99_fresh``: the 99th percentile, over the sampled bodies,
of the relative error of the treecode's force on acceptance lists built
fresh on the window's final state (``ops.registry.tree_fns`` of the run's
configuration), against the plain reference's exact sum. Beside
``force_err_p99`` it tells the acceptance's error from the cadence's."""

import numpy as np
import torch

from nbody_bench import judge
from nbody_bench.metrics._common import is_tree
from nbody_bench.reference.gravity import accel


def read(trace, run) -> float | None:
    if not is_tree(run):
        return None
    from n_body_problem_tpu_torch.ops.registry import tree_fns

    sim = run.system.sim
    build, force = tree_fns(sim.cfg)
    s = sim.state
    with torch.no_grad():
        acc = force(s.pos, s.mass, build(s.pos, s.mass))
    rng = np.random.default_rng([run.seed % 2**64, 3])
    slots = torch.as_tensor(judge.sample_slots(run.n, run.cell.config["probe_bodies"], rng),
                            device=s.pos.device)
    ids = torch.as_tensor(np.asarray(sim.sort_perm), device=s.pos.device)
    x = s.pos.double()
    m = torch.as_tensor(run.mass, dtype=torch.float64, device=x.device)[ids]
    ref = accel(x[slots], x, m, run.phys)
    err = (acc[slots].double() - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
    return float(np.percentile(err.cpu().numpy(), 99))
