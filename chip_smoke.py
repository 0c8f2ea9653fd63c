#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``n_body_problem_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of what it found; any failure raises, so
the exit code is non-zero:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit; TF32 matmuls must be off.
2. build: compiles the kernels from ``n_body_problem_tpu_torch/csrc``.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at N = 128, 896 (odd tile count), 1,024 (90 padding bodies) and 65,536,
   within rtol=1e-4, atol=2e-6 (the JAX package's bounds for these kernels
   against the direct oracle); the all-pairs kernel also in its block form
   (rows != columns) and for bitwise repeatability; the symmetric kernel
   also for momentum (|sum m a| < 1e-6). Times both kernels and both plain
   versions at N = 65,536.
4. main path: ``Simulation(SimConfig(), plummer(65536), device="cuda")``
   (the default solver, the symmetric kernel), then ``solver="pallas"``
   (the all-pairs kernel), then leapfrog; each primed with 5 steps and
   timed over 50; launch counters show that each kernel ran. Then the
   energy check of the JAX package's test (N=256, seed 4, dt=0.002, 200
   steps) through the symmetric kernel.
5. CLI: ``python -m n_body_problem_tpu_torch run`` on a galaxy collision of
   20,480 stars in a subprocess.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
TOL = dict(rtol=1e-4, atol=2e-6)
PHYS = dict(eps2=1e-6, compensate=0.1, G=1.0)
# (padded N, real N): one tile, odd tile count, padding bodies, full size.
SIZES = ((128, 128), (896, 896), (1024, 934), (65536, 65536))
N_MAIN = 65536
PRIME_STEPS, TIMED_STEPS = 5, 50


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cloud(n: int, n_real: int, seed: int, device):
    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.state import pad_state_to

    return pad_state_to(models.plummer(n_real, seed=seed), n).to(device)


def compare_kernels(device, sizes=SIZES, time_at: int | None = N_MAIN) -> dict:
    """Phase 3: each kernel against its plain version; returns per-kernel
    ``max_abs_err`` and, at ``time_at`` bodies, ``ms`` and ``plain_ms``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric

    tile = cuda_symmetric.KERNEL_TILE
    res = {"allpairs": {"max_abs_err": 0.0}, "symmetric": {"max_abs_err": 0.0}}

    def agree(name, key, got, want):
        err = float((got - want).abs().max())
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.allclose(got, want, **TOL),
              f"{name}: max |kernel - plain| = {err:.3e} outside rtol=1e-4, atol=2e-6")
        return err

    for n, n_real in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        tiles = dict(tile_i=tile, tile_j=tile)
        a = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        ea = agree(f"allpairs N={n}", "allpairs", a,
                   cuda_force.block_acc_plain(pos, pos, mass, **PHYS))
        a2 = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        check(torch.equal(a, a2), f"allpairs N={n}: two launches differ bitwise")
        rows = cloud(384, 384, seed=n + 1, device=device).pos + 0.5
        ab = cuda_force.block_acc(rows, pos, mass, **tiles, **PHYS)
        eb = agree(f"allpairs block 384x{n}", "allpairs", ab,
                   cuda_force.block_acc_plain(rows, pos, mass, **PHYS))
        b = cuda_symmetric.symmetric_acc(pos, mass, tile=tile, **PHYS)
        es = agree(f"symmetric N={n}", "symmetric", b,
                   cuda_symmetric.symmetric_acc_plain(pos, mass, tile=tile, **PHYS))
        net = float((mass[:, None] * b).sum(0).abs().max())
        check(net < 1e-6, f"symmetric N={n}: |sum m a| = {net:.3e} >= 1e-6")
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # a fault in the run shows here
        print(f"kernels: N={n} (real {n_real}) allpairs err {ea:.3e} "
              f"block(384x{n}) err {eb:.3e} bitwise-repeatable; symmetric err "
              f"{es:.3e} |sum m a| {net:.3e}", flush=True)

        if n == time_at:
            res["allpairs"]["ms"] = time_ms(
                lambda: cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS), 20)
            res["allpairs"]["plain_ms"] = time_ms(
                lambda: cuda_force.block_acc_plain(pos, pos, mass, **PHYS), 3)
            res["symmetric"]["ms"] = time_ms(
                lambda: cuda_symmetric.symmetric_acc(pos, mass, tile=tile, **PHYS), 20)
            res["symmetric"]["plain_ms"] = time_ms(
                lambda: cuda_symmetric.symmetric_acc_plain(
                    pos, mass, tile=tile, **PHYS), 3)
            print("kernels: times at N={} (ms/call) allpairs {:.4f} vs plain {:.4f}; "
                  "symmetric {:.4f} vs plain {:.4f}".format(
                      n, res["allpairs"]["ms"], res["allpairs"]["plain_ms"],
                      res["symmetric"]["ms"], res["symmetric"]["plain_ms"]), flush=True)
    return res


def drive_main_path(device, n: int = N_MAIN, prime: int = PRIME_STEPS,
                    timed: int = TIMED_STEPS) -> None:
    """Phase 4a: the default simulation, then solver="pallas", then
    leapfrog, each through the public ``Simulation`` entry point."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric

    runs = (
        ("default", SimConfig(), "pallas_symmetric", cuda_symmetric.symmetric_acc),
        ("pallas", SimConfig(solver="pallas"), "pallas", cuda_force.block_acc),
        ("leapfrog", SimConfig(integrator="leapfrog"), "pallas_symmetric",
         cuda_symmetric.symmetric_acc),
    )
    for label, cfg, solver, wrapper in runs:
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        check(sim.solver == solver, f"{label}: resolved {sim.solver!r}, expected {solver!r}")
        e0 = sim.diagnostics()["energy"]
        sim.run(prime)
        before, wall0 = wrapper.launches, sim.wall_seconds
        sim.run(timed)
        launched = wrapper.launches - before
        wall = sim.wall_seconds - wall0
        check(launched >= timed, f"{label}: kernel launched {launched} times in {timed} steps")
        check(bool(torch.isfinite(sim.state.pos).all()), f"{label}: non-finite positions")
        d = sim.diagnostics()
        check(d["overspeed"] == 0, f"{label}: overspeed {d['overspeed']}")
        check(d["step"] == prime + timed, f"{label}: step {d['step']}")
        ms = wall / timed * 1e3
        print(f"main path [{label}]: N={sim.state.n_real} solver={sim.solver} "
              f"integrator={cfg.integrator} {ms:.4f} ms/step "
              f"{sim.pairs_per_step() * timed / wall:.4e} pairs/s "
              f"launches {launched} |dE/E| after {prime + timed} steps "
              f"{abs((d['energy'] - e0) / e0):.3e}", flush=True)


def energy_check(device) -> None:
    """Phase 4b: the JAX package's energy-drift test, through the
    symmetric kernel (tests/test_integrators.py:53-64)."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, diagnostics, models

    for integrator, tol in (("leapfrog", 1e-4), ("semi_implicit_euler", 5e-3)):
        cfg = SimConfig(solver="pallas_symmetric", integrator=integrator, dt=0.002,
                        eps2=1e-6, compensate=0.1)
        sim = Simulation(cfg, models.plummer(256, seed=4), device=device)
        e0 = float(diagnostics.total_energy(sim.state, cfg))
        sim.run(200)
        e1 = float(diagnostics.total_energy(sim.state, cfg))
        drift = abs((e1 - e0) / e0)
        check(drift < tol, f"energy [{integrator}]: |dE/E| {drift:.3e} >= {tol}")
        print(f"energy [{integrator}]: N=256 200 steps |dE/E| {drift:.3e} < {tol}",
              flush=True)


def run_cli(out: pathlib.Path, n: int = 20480, device: str | None = None) -> None:
    """Phase 5: the CLI's ``run`` subcommand in a subprocess."""
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "n_body_problem_tpu_torch", "run",
           "--model", "galaxy_collision", "--n", str(n), "--steps", "20",
           "--diag-every", "10", "--out", str(out)]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stderr.splitlines():
        print(f"  cli| {line}")
    check(proc.returncode == 0, f"cli: rc={proc.returncode}")
    state, _ = load_checkpoint(out / "final.npz")
    check(int(state.step) == 20, f"cli: final.npz at step {int(state.step)}")
    check(bool(state.pos.isfinite().all()), "cli: non-finite positions in final.npz")
    print(f"cli: rc 0, final.npz with {state.n_real} bodies at step 20", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from n_body_problem_tpu_torch.ops import cuda_build, cuda_force, cuda_symmetric

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | tf32 off", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    log = (cuda_build.library_path().parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas| {line.strip()}")
    print(f"build: {build_s:.3f} s -> {cuda_build.library_path()}", flush=True)

    res = compare_kernels(device)

    cuda_force.block_acc.launches = 0
    cuda_symmetric.symmetric_acc.launches = 0
    drive_main_path(device)
    launches = {"allpairs": cuda_force.block_acc.launches,
                "symmetric": cuda_symmetric.symmetric_acc.launches}
    for key, count in launches.items():
        check(count > 0, f"main path never launched the {key} kernel")
    energy_check(device)
    run_cli(ROOT / "out" / "chip_smoke_cli")

    kernels = [
        {"name": "allpairs_acc_kernel", "route": "cuda",
         "source": "n_body_problem_tpu_torch/csrc/allpairs.cu",
         "replaces": "n_body_problem_tpu/ops/pallas_force.py:41",
         "launches": launches["allpairs"], **res["allpairs"]},
        {"name": "symmetric_acc_kernel", "route": "cuda",
         "source": "n_body_problem_tpu_torch/csrc/symmetric.cu",
         "replaces": "n_body_problem_tpu/ops/pallas_symmetric.py:87",
         "launches": launches["symmetric"], **res["symmetric"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
