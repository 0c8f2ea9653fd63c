"""The comparison that decides ``correct``: a call's result against the plain
reference (``nbody_bench.reference``), body by body on a sample.

A call of ``n`` semi-implicit Euler steps turns the state ``prev`` (the one
the previous call returned) into ``cur``, whose ``acc`` is the force of its
last step, taken at ``x_last = x - v dt`` (``prev``'s positions when
``n = 1``). The reference works out, in float64 from the benchmark's own
masses and the positions it judges:

- ``force_p99``: the 99th percentile over the sampled bodies of
  ``|acc - a_ref(x_last)| / |a_ref(x_last)|``, ``a_ref`` the exact sum over
  every body: the force the call's solver gave (kernel 2, or the treecode on
  its acceptance lists);
- ``dx_p90``: the 90th percentile of ``|dx - dx_ref| / |dx_ref|``, ``dx``
  a body's move over the call and ``dx_ref = n dt v_0 + dt^2 n (n + 1)
  (a_first / 3 + a_last / 6)``, the Euler sum of ``n`` steps with the force
  taken linear from ``a_ref(x_0)`` to ``a_ref(x_last)``: the integrator's
  update and the steps the call took (exact for ``n = 1``);
- ``frame_rel`` (where the loop renders): ``|F - F_ref| / |F_ref|`` over
  every pixel, ``F_ref`` the plain splat of ``cur``'s positions;
- ``steps_gap``: ``|(cur.step - prev.step) - n|``, the steps the system's
  own counter says the call took against the ``n`` the loop asked for, held
  to 0 (the harness holds the window's whole count to it too, with the
  last judged call's, and ``ms_per_step`` divides by that count).

Bodies are matched across calls by their input index (a treecode run
re-sorts them). The sample is a stride over ``cur``'s slots, every
``n // count``-th from an offset drawn from the seed: in a Morton-sorted
state a spatially stratified sample, as ``n_body_problem_tpu_torch/bench.py``
at commit c8a9ef2832dd3ca6223213d0b57046ed74f6d186 takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_bench.reference import splat
from nbody_bench.reference.gravity import Physics, accel
from nbody_bench.snapshot import Snapshot

_TINY = 1e-30


def sample_slots(n: int, count: int, rng: np.random.Generator) -> np.ndarray:
    """``min(count, n)`` slots, one every ``n // count`` from a seeded offset."""
    stride = max(n // count, 1)
    return int(rng.integers(stride)) + np.arange(0, stride * min(count, n), stride)


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(_TINY)


def _pct(x: torch.Tensor, q: float) -> float:
    return float(np.percentile(x.double().cpu().numpy(), q))


def judge_call(prev: Snapshot, cur: Snapshot, n_steps: int, mass: np.ndarray, phys: Physics,
               slots: np.ndarray, frame: torch.Tensor | None = None,
               view: dict | None = None) -> dict[str, float]:
    """The numbers of one call (``prev`` -> ``cur``) on the sampled ``slots``
    of ``cur``; ``mass`` the input masses in input order."""
    dev = cur.pos.device
    f64 = torch.float64
    ids_cur = cur.input_ids()
    where_prev = np.empty_like(prev.input_ids())
    where_prev[prev.input_ids()] = np.arange(len(where_prev))
    m_in = torch.as_tensor(mass, dtype=f64, device=dev)
    s_cur = torch.as_tensor(slots, device=dev)
    s_prev = torch.as_tensor(where_prev[ids_cur[slots]], device=dev)

    x0 = prev.pos.to(f64)
    m0 = m_in[torch.as_tensor(prev.input_ids(), device=dev)]
    a_first = accel(x0[s_prev], x0, m0, phys)
    if n_steps == 1:
        a_last = a_first
    else:
        x_last = cur.pos.to(f64) - cur.vel.to(f64) * phys.dt
        m1 = m_in[torch.as_tensor(ids_cur, device=dev)]
        a_last = accel(x_last[s_cur], x_last, m1, phys)
    out = {"force_p99": _pct(_rel(cur.acc[s_cur].to(f64), a_last), 99),
           "steps_gap": float(abs(int(cur.step) - int(prev.step) - n_steps))}

    dt, n = phys.dt, n_steps
    dx = cur.pos[s_cur].to(f64) - x0[s_prev]
    dx_ref = (n * dt * prev.vel[s_prev].to(f64)
              + dt * dt * n * (n + 1) * (a_first / 3.0 + a_last / 6.0))
    out["dx_p90"] = _pct(_rel(dx, dx_ref), 90)

    if frame is not None:
        vp = splat.view_projection(view["theta_deg"], view["phi_deg"], view["distance"],
                                   view["width"] / view["height"])
        m_cur = m_in[torch.as_tensor(ids_cur, device=dev)]
        ref = splat.frame(cur.pos, m_cur, vp, view["scale"], width=view["width"],
                          height=view["height"])
        got = frame.to(dev, f64)
        out["frame_rel"] = float((got - ref).norm() / ref.norm().clamp_min(_TINY))
    return out


def verdict(numbers: list[dict[str, float]], limits: dict[str, float]) -> tuple[dict, int]:
    """``(checks, failed)``: each number's worst reading over the judged
    calls beside its limit, and the count of calls with a number over its
    limit or not finite (a number the limits do not name is a fault of the
    benchmark and raises)."""
    checks, failed = {}, 0
    for nums in numbers:
        bad = False
        for k, v in nums.items():
            lim = limits[k]
            bad |= not (np.isfinite(v) and v <= lim)
            worst = checks.get(k, {"value": -np.inf})["value"]
            checks[k] = {"value": v if not np.isfinite(v) or v > worst else worst, "limit": lim}
        failed += bad
    return checks, failed
