"""The comparison that decides ``correct``: a call's result against the plain
reference (``nbody_bench.reference``), body by body on a sample.

A call of ``n`` steps turns the state ``prev`` (the one the previous call
returned) into ``cur``. Both hold the configuration's ``N`` real bodies
alone: a snapshot whose ``input_ids()`` is not a permutation of
``range(N)``, or whose arrays do not hold ``N`` rows, is not judged and
reads ``force_p99`` NaN, a failed call (a program that hands back its
padding, or moves it into the real slots, is caught so). The reference
works out, in float64 from the benchmark's own masses and the positions it
judges, with the force ``a_ref``, the exact sum over every body:

- ``force_p99``: the 99th percentile over the sampled bodies of
  ``|acc - a_ref(x_last)| / |a_ref(x_last)|``, ``acc`` the state's force of
  its last step: the force the call's solver gave (kernel 2, or the
  treecode on its acceptance lists). ``x_last`` follows the configuration's
  ``physics.integrator`` (``reference.gravity.INTEGRATORS``): under
  ``semi_implicit_euler`` the positions the last step started from,
  ``x - v dt`` (``prev``'s positions when ``n = 1``), so the returned
  velocity is held too; under ``leapfrog`` (KDK, stored-acceleration form)
  the state's own ``x``;
- ``dx_p90``: the 90th percentile of ``|dx - dx_ref| / |dx_ref|``, ``dx``
  a body's move over the call and ``dx_ref`` the sum of ``n`` steps of the
  integrator with the force taken linear between ``a_first = a_ref(x_0)``
  and ``a_last = a_ref(x_last)``: the integrator's update and the steps
  the call took (exact for ``n = 1``);
- under ``leapfrog`` alone, whose force does not hold the velocity:
  ``dv_p90``, the 90th percentile of ``|dv - dv_ref| / |dv_ref|``, ``dv``
  a body's velocity change over the call and ``dv_ref`` the trapezoid sum
  of the call's forces from ``a_first``, ``a_last`` and their time
  derivatives ``j`` at the two ends (the reference's ``jerk`` at the
  states' positions and velocities; exact for a force cubic in time); and
  ``dv_lag``, ``|median((dv - dv_ref) . a_last / (dt |a_last|^2))|``, the
  velocity's shift along the force in kicks of a step: a closing half-kick
  left out, or taken twice, reads 0.5 on every body, where the error of
  the sum above scatters in direction and its median is near 0;
- ``frame_rel`` (where the loop renders): ``|F - F_ref| / |F_ref|`` over
  every pixel, ``F`` the program's whole frame and ``F_ref`` the plain
  splat of ``cur``'s positions;
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
from nbody_bench.reference.gravity import INTEGRATORS, Physics, accel, jerk
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


def is_real(snap: Snapshot, n: int) -> bool:
    """Whether ``snap`` holds ``n`` bodies, each input index once (O(n) on
    the host)."""
    ids = snap.input_ids()
    if any(a.shape[0] != n for a in (snap.pos, snap.vel, snap.acc)) or ids.shape != (n,):
        return False
    if not np.issubdtype(ids.dtype, np.integer) or ids.min() < 0 or ids.max() >= n:
        return False
    seen = np.zeros(n, dtype=bool)
    seen[ids] = True
    return bool(seen.all())


def judge_call(prev: Snapshot, cur: Snapshot, n_steps: int, mass: np.ndarray, phys: Physics,
               slots: np.ndarray, frame: torch.Tensor | None = None,
               view: dict | None = None) -> dict[str, float]:
    """The numbers of one call (``prev`` -> ``cur``) on the sampled ``slots``
    of ``cur``; ``mass`` the input masses in input order."""
    steps_gap = float(abs(int(cur.step) - int(prev.step) - n_steps))
    if not (is_real(prev, len(mass)) and is_real(cur, len(mass))):
        return {"force_p99": float("nan"), "steps_gap": steps_gap}
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
    rule = INTEGRATORS[phys.integrator]
    m1 = m_in[torch.as_tensor(ids_cur, device=dev)]
    if n_steps == 1 and rule.acc_lags:
        a_last = a_first
    else:
        x_last = cur.pos.to(f64)
        if rule.acc_lags:
            x_last = x_last - cur.vel.to(f64) * phys.dt
        a_last = accel(x_last[s_cur], x_last, m1, phys)
    out = {"force_p99": _pct(_rel(cur.acc[s_cur].to(f64), a_last), 99),
           "steps_gap": steps_gap}

    dt, v0 = phys.dt, prev.vel.to(f64)
    dx = cur.pos[s_cur].to(f64) - x0[s_prev]
    out["dx_p90"] = _pct(_rel(dx, rule.dx_ref(n_steps, dt, v0[s_prev], a_first, a_last)), 90)
    if rule.dv_ref is not None:
        x1, v1 = cur.pos.to(f64), cur.vel.to(f64)
        j_first = jerk(x0[s_prev], v0[s_prev], x0, v0, m0, phys)
        j_last = jerk(x1[s_cur], v1[s_cur], x1, v1, m1, phys)
        want = rule.dv_ref(n_steps, dt, a_first, a_last, j_first, j_last)
        err = v1[s_cur] - v0[s_prev] - want
        out["dv_p90"] = _pct(err.norm(dim=1) / want.norm(dim=1).clamp_min(_TINY), 90)
        lag = (err * a_last).sum(1) / (dt * (a_last * a_last).sum(1)).clamp_min(_TINY)
        out["dv_lag"] = abs(float(lag.median()))

    if frame is not None:
        vp = splat.view_projection(view["theta_deg"], view["phi_deg"], view["distance"],
                                   view["width"] / view["height"])
        ref = splat.frame(cur.pos, m1, vp, view["scale"], width=view["width"],
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
