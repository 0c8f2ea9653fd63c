"""n_body_problem_tpu_torch — the N-body engine on PyTorch and CUDA.

A port of ``n_body_problem_tpu`` (JAX, XLA and Pallas for the TPU) to
PyTorch with hand-written CUDA kernels for Hopper (``csrc/``). The JAX
package is the reference it is tested against; this package imports no JAX.

Ported so far: the exact direct-sum simulation (config, state, the
procedural models, the plain PyTorch solvers and the pair-matrix foil, the
all-pairs CUDA kernel and the symmetric half-pair kernels in the f32,
bf16x3 and mixed precisions, both integrators, diagnostics, checkpoints, the
``run``/``info`` CLI) and the treecode run loop on its hierarchical,
single-level flat and dense paths (Morton sort, acceptance builds, the near,
far, panel-gather, near-panel and VIP CUDA kernels), with the JAX
package's tools on one device: the dataset readers and writers (``io``),
the bench harness (``bench``), the physics validation (``validate``),
profiler traces (``utils.profiling``), the splat renderer with
``Simulation.movie``/``trajectory``, the frame writer and the live viewer
(``render``), and the ``run``/``info``/``convert``/``render``/``bench``
CLI; and on several devices, the exact ring, the half ring and the sharded
treecode (``parallel``: ``ShardedSimulation`` on ``torch.distributed``, the
CLI's ``--devices``/``--strategy``). Entry points run on ``cuda`` unless
asked for the CPU.

Public API::

    import n_body_problem_tpu_torch as nb

    sim = nb.Simulation(nb.SimConfig(), nb.models.plummer(65536, seed=0),
                        device="cuda")
    sim.run(100)
    print(sim.diagnostics())
    frames = sim.movie(20, render_every=10, camera=nb.render.OrbitCamera(distance=2.0))

    tree = nb.Simulation(nb.SimConfig(solver="treecode"),
                         nb.models.plummer(524288, seed=0), device="cuda")
    tree.run(16)
"""

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.state import (
    SimState,
    from_numpy,
    make_state,
    pad_state,
    to_numpy,
    unpad_state,
)
from n_body_problem_tpu_torch.simulation import Simulation, make_step_fn, run_steps
from n_body_problem_tpu_torch import diagnostics
from n_body_problem_tpu_torch import models
from n_body_problem_tpu_torch import ops
from n_body_problem_tpu_torch import io
from n_body_problem_tpu_torch import parallel
from n_body_problem_tpu_torch import render

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "SimState",
    "from_numpy",
    "make_state",
    "pad_state",
    "to_numpy",
    "unpad_state",
    "Simulation",
    "make_step_fn",
    "run_steps",
    "diagnostics",
    "models",
    "ops",
    "io",
    "parallel",
    "render",
]
