#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``n_body_problem_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises, so the exit code
is non-zero:

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit; TF32 matmuls must be off.
2. build: compiles the kernels from ``n_body_problem_tpu_torch/csrc``.
3. exact kernels: the all-pairs and symmetric kernels against their plain
   PyTorch versions at N = 128, 896 (odd tile count), 1,024 (90 padding
   bodies) and 65,536, within rtol=1e-4, atol=2e-6; the all-pairs kernel
   also in block form and for bitwise repeatability; the symmetric kernel
   for momentum. Times both at N = 65,536.
4. treecode kernels: every treecode kernel against its plain version on
   the port's own work lists, at the shapes of every treecode run of phase
   6 and one smaller: the hierarchical path (near, far, VIP) on Plummer
   spheres of 8,192, 20,480 (with ``tuned_tree_overrides``: 32-body source
   tiles, so 64 entries fill the near kernel's 2,048-body stage), 65,536
   and 524,288 bodies; the single-level flat path (near at 32-body rows,
   single-level far, VIP) at 20,480 and 65,536 with ``tree_hier=False`` and
   at 2,560; the dense path (gather, near-panel, single-level far, VIP) at
   1,024 (every tile near, so no far field) and at 20,480 with
   ``tree_flat_cap=-1``. Within rtol=1e-4, atol=2e-6 on the raw outputs,
   the gather exactly; each launch repeated for bitwise equality. Times
   each kernel at the largest shape of its path, beside its plain version,
   its bound and (the gather) one ``index_select`` call.
5. exact main path: ``Simulation(SimConfig(), plummer(65536))`` (the
   symmetric kernel), ``solver="pallas"`` (the all-pairs kernel) and
   leapfrog; launch counters show that each kernel ran.
6. treecode main path: ``Simulation(SimConfig(solver="treecode"))`` at
   N = 65,536 (Euler, then leapfrog; 8 steps primed, 64 timed), at 20,480
   with ``tuned_tree_overrides(20480)`` and at 524,288 (16 timed); then the
   flat path at 20,480 (``tree_hier=False``, the galaxy_20K scale), at
   65,536 with leapfrog and at 2,560 (chosen by N alone), and the dense
   path at 1,024 (chosen by N alone) and at 20,480 (``tree_flat_cap=-1``),
   64 timed steps each. Each run must launch exactly the kernels its path
   makes a step (``launches_a_step``), keep positions finite and overspeed
   0. After it the treecode force on lists built afresh (``bench.py``'s
   probe) must stay within p99 2.5e-3 and median 5e-4 of the all-pairs
   kernel's exact force (all bodies, or 2,048 sampled at 524,288); the
   error on the lists the run last stepped with, ``tree_rebuild_every``
   steps old, is printed beside it. A ``torch.profiler`` trace of 16 steps
   at 65,536, 20,480 flat and 20,480 dense gives the step's breakdown and
   the device's idle share.
7. energy: the JAX package's energy-drift test through the symmetric kernel.
8. CLI: ``python -m n_body_problem_tpu_torch run`` on a galaxy collision of
   20,480 stars, with the default solver and with ``--solver treecode
   --tree-tuned``, in subprocesses.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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
PRIME_STEPS, TIMED_STEPS = 5, 20
TREE_PRIME, TREE_TIMED = 8, 64
ERR_P99, ERR_MEDIAN = 2.5e-3, 5e-4   # tests/test_treecode_hier.py:126-127
TREE_KERNELS = ("near", "far", "vip", "far_single", "gather", "near_panel")
# FP32 operations a kernel does per interaction, an FMA counted as two and an
# rsqrt as one: a body pair one way (near kernels), a pair both ways (VIP
# sweep, symmetric kernel), a body against a node's monopole + quadrupole.
PAIR_FLOPS, PAIR_BOTH_FLOPS, NODE_FLOPS = 20, 27, 56
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM FP32 non-tensor, HBM3


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cloud(n: int, n_real: int, seed: int, device):
    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.state import pad_state_to

    return pad_state_to(models.plummer(n_real, seed=seed), n).to(device)


def agree(res: dict, key: str, name: str, got, want) -> float:
    """Hold a kernel's output against its plain version's; keeps the
    largest |difference| in ``res[key]``."""
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.allclose(got, want, **TOL),
          f"{name}: max |kernel - plain| = {err:.3e} outside rtol=1e-4, atol=2e-6")
    return err


def compare_kernels(device, sizes=SIZES, time_at: int | None = N_MAIN) -> dict:
    """Phase 3: each exact kernel against its plain version; returns
    per-kernel ``max_abs_err`` and, at ``time_at`` bodies, ``ms`` and
    ``plain_ms``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    tile = cuda_symmetric.KERNEL_TILE
    res = {"allpairs": {"max_abs_err": 0.0}, "symmetric": {"max_abs_err": 0.0}}
    for n, n_real in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        tiles = dict(tile_i=tile, tile_j=tile)
        a = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        ea = agree(res, "allpairs", f"allpairs N={n}", a,
                   cuda_force.block_acc_plain(pos, pos, mass, **PHYS))
        a2 = cuda_force.block_acc(pos, pos, mass, **tiles, **PHYS)
        check(torch.equal(a, a2), f"allpairs N={n}: two launches differ bitwise")
        rows = cloud(384, 384, seed=n + 1, device=device).pos + 0.5
        ab = cuda_force.block_acc(rows, pos, mass, **tiles, **PHYS)
        eb = agree(res, "allpairs", f"allpairs block 384x{n}", ab,
                   cuda_force.block_acc_plain(rows, pos, mass, **PHYS))
        b = cuda_symmetric.symmetric_acc(pos, mass, tile=tile, **PHYS)
        es = agree(res, "symmetric", f"symmetric N={n}", b,
                   cuda_symmetric.symmetric_acc_plain(pos, mass, tile=tile, **PHYS))
        net = float((mass[:, None] * b).sum(0).abs().max())
        check(net < 1e-6, f"symmetric N={n}: |sum m a| = {net:.3e} >= 1e-6")
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
            # Inputs read once (positions and masses), the (N, 3) output
            # written once; the symmetric kernel takes each pair once.
            nbytes = n * 16 + n * 12
            res["allpairs"].update(library_ms=None, **bound(PAIR_FLOPS * n * n, nbytes))
            res["symmetric"].update(library_ms=None,
                                    **bound(PAIR_BOTH_FLOPS * n * (n - 1) // 2, nbytes))
            print("kernels: times at N={} (ms/call) allpairs {:.4f} vs plain {:.4f}; "
                  "symmetric {:.4f} vs plain {:.4f}".format(
                      n, res["allpairs"]["ms"], res["allpairs"]["plain_ms"],
                      res["symmetric"]["ms"], res["symmetric"]["plain_ms"]), flush=True)
    return res


def tree_inputs(n: int, device, seed: int = 0, **overrides) -> dict:
    """The treecode kernels' arguments at the shapes the main path gives
    them: a Plummer sphere through ``Simulation``'s sort, padding and
    capacity planning, then the acceptance build of the path it takes.
    ``kernels`` maps each kernel the path launches to ``(args, kw)``; the
    near-panel kernel takes the plain gather's panels, so that its check
    does not rest on the gather kernel."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path

    sim = Simulation(SimConfig(solver="treecode", **overrides),
                     models.plummer(n, seed=seed), device=device)
    cfg, s = sim.cfg, sim.state
    path, tile, src = tree_path(cfg), cfg.tree_tile, cfg.tree_src_tile
    aux = tree_fns(cfg)[0](s.pos, s.mass)
    phys = dict(eps2=cfg.eps2, c2=cfg.compensate ** 2)
    far_kw = dict(n=s.n, tile=tile, G=cfg.G, **phys)
    if path == "dense":
        k, max_near, vip = treecode._static_args(s.n, tile, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles)
        ops = treecode.kernel_operands(s.pos, s.mass, aux[2], compensate=cfg.compensate,
                                       G=cfg.G, src_tile=tile, vip_src=vip,
                                       plan=(k,) if max_near < k else None)
        b = ops["bodies"]
        kernels = {"gather": ((b, aux[0]), dict(tile=tile)),
                   "near_panel": ((b, ct.gather_panels_plain(b, aux[0], tile=tile)),
                                  dict(tile=tile, **phys))}
        if max_near < k:
            kernels["far_single"] = ((b, ops["summ"], aux[1]), far_kw)
    else:
        hier = path == "hier"
        st = (treecode._hier_static(s.n, tile, src, cfg.tree_theta, cfg.tree_max_near,
                                    cfg.tree_vip_tiles, cfg.tree_far_max, treecode.HIER_BRANCH)
              if hier else treecode._flat_static(s.n, tile, src, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles))
        ops = treecode.kernel_operands(s.pos, s.mass, aux[-1], compensate=cfg.compensate,
                                       G=cfg.G, src_tile=src, vip_src=st[4],
                                       plan=st[5] if hier else (st[1],))
        b = ops["bodies"]
        kernels = {"near": ((b, aux[0], aux[1]),
                            dict(n=s.n, tile=tile, src_tile=src, entries=st[2], **phys))}
        if hier:
            kernels["far"] = ((b, ops["summ"], aux[2], aux[3]), far_kw)
        else:
            kernels["far_single"] = ((b, ops["summ"], aux[2]), far_kw)
    if ops["rows"] is not None:
        kernels["vip"] = ((ops["rows"], ops["panel"]), phys)
    return dict(n=s.n, cfg=cfg, path=path, ops=ops, aux=aux, kernels=kernels)


def tree_kernel_cases():
    """(label, N, overrides): the shapes of every treecode run of phase 6,
    and a smaller one."""
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    return (("8,192", 8192, {}), ("20,480 tuned", 20480, tuned_tree_overrides(20480)),
            ("65,536", 65536, {}), ("524,288", 524288, {}),
            ("20,480 flat", 20480, dict(tree_hier=False)),
            ("65,536 flat", 65536, dict(tree_hier=False)),
            ("2,560", 2560, {}), ("1,024", 1024, {}),
            ("20,480 dense", 20480, dict(tree_flat_cap=-1)))


def tree_work(key: str, args, kw) -> dict:
    """``bound`` of a treecode kernel's call, counting the interactions
    these inputs need (sentinel entries and masked tiles are skipped) and
    each input read and each output written once."""
    from n_body_problem_tpu_torch.ops.cuda_treecode import FAR_ENTRIES

    nbytes = sum(a.numel() * a.element_size() for a in args)
    if key == "near":
        bodies, flat_src, chunk_tgt = args
        n, e = kw["n"], kw["entries"]
        ids = flat_src[:chunk_tgt.shape[0] * e].reshape(-1, e)
        real = (ids != n // kw["src_tile"]) & (chunk_tgt < n // kw["tile"])[:, None]
        return bound(PAIR_FLOPS * int(real.sum()) * kw["src_tile"] * kw["tile"],
                     nbytes + n * 12)
    if key == "far":
        bodies, summ, far_src, far_tgt = args
        n = kw["n"]
        ids = far_src[:far_tgt.shape[0] * FAR_ENTRIES].reshape(far_tgt.shape[0], -1)
        real = (ids != summ.shape[0] - 1) & (far_tgt < n // kw["tile"])[:, None]
        return bound(NODE_FLOPS * int(real.sum()) * kw["tile"], nbytes + n * 12)
    if key == "far_single":
        bodies, summ, mask = args
        live = mask.numel() - int(mask.sum())
        return bound(NODE_FLOPS * live * kw["tile"], nbytes + kw["n"] * 12)
    if key == "gather":
        bodies, near_idx = args
        return bound(0, nbytes + near_idx.numel() * kw["tile"] * 16)
    if key == "near_panel":
        bodies, panels = args
        k, w = panels.shape[:2]
        return bound(PAIR_FLOPS * k * kw["tile"] * w, nbytes + k * kw["tile"] * 12)
    rows, panel = args   # vip: action on every row, reaction on the panel
    return bound(PAIR_BOTH_FLOPS * rows.shape[0] * panel.shape[0],
                 nbytes + (rows.shape[0] + panel.shape[0]) * 12)


def gather_library(bodies, near_idx, *, tile: int):
    """One PyTorch call computing the gather: ``index_select`` of the
    (K + 1, T, 4) tile view (timed as the gather's yardstick only)."""
    tiles = bodies.view(-1, tile, 4)
    return tiles.index_select(0, near_idx.reshape(-1)).view(near_idx.shape[0], -1, 4)


# Where each treecode kernel is timed: the largest shape of the path it
# serves (case label of ``tree_kernel_cases``).
TIME_AT = {"near": "65,536", "far": "65,536", "vip": "65,536",
           "far_single": "65,536 flat", "gather": "20,480 dense",
           "near_panel": "20,480 dense"}


def compare_tree_kernels(device, cases=None, time_at: dict | None = None) -> dict:
    """Phase 4: each treecode kernel against its plain version on the
    port's work lists (the gather exactly); bitwise repeatability; times,
    bounds and the gather's library call at the shapes of ``time_at``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    fns = {"near": (ct.near_field, ct.near_field_plain),
           "far": (ct.far_field_hier, ct.far_field_hier_plain),
           "vip": (ct.vip_both, ct.vip_both_plain),
           "far_single": (ct.far_field_single, ct.far_field_single_plain),
           "gather": (ct.gather_panels, ct.gather_panels_plain),
           "near_panel": (ct.near_panel, ct.near_panel_plain)}
    time_at = TIME_AT if time_at is None else time_at
    res = {k: {"max_abs_err": 0.0} for k in TREE_KERNELS}
    for label, n, overrides in cases or tree_kernel_cases():
        inp = tree_inputs(n, device, **overrides)
        line = []
        for key, (args, kw) in inp["kernels"].items():
            kernel, plain = fns[key]
            got, again = kernel(*args, **kw), kernel(*args, **kw)
            want = plain(*args, **kw)
            if key == "vip":
                err = max(agree(res, key, f"vip action N={label}", got[0], want[0]),
                          agree(res, key, f"vip reaction N={label}", got[1], want[1]))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
            elif key == "gather":
                check(torch.equal(got, want), f"gather N={label}: kernel != plain copy")
                err = 0.0
                same = torch.equal(got, again)
            else:
                err = agree(res, key, f"{key} N={label}", got, want)
                same = torch.equal(got, again)
            check(same, f"{key} N={label}: two launches differ bitwise")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            line.append(f"{key} err {err:.3e}")
            if key == "near" and inp["cfg"].tree_tile == 32 and device.type == "cuda":
                line.append("near at tile 32 {:.4f} ms, bound {:.4f}".format(
                    time_ms(lambda: kernel(*args, **kw), 20),
                    tree_work(key, args, kw)["bound_ms"]))
            if time_at.get(key) == label:
                res[key]["ms"] = time_ms(lambda: kernel(*args, **kw), 20)
                res[key]["plain_ms"] = time_ms(lambda: plain(*args, **kw), 3)
                res[key]["library_ms"] = None
                if key == "gather":
                    check(torch.equal(gather_library(*args, **kw), got),
                          f"gather N={label}: index_select != kernel")
                    res[key]["library_ms"] = time_ms(lambda: gather_library(*args, **kw), 20)
                res[key].update(tree_work(key, args, kw))
        c, ops = inp["cfg"], inp["ops"]
        shapes = " ".join(f"{x.shape[0]}x{x.shape[1]}" if x.dim() > 1 else str(x.shape[0])
                          for x in inp["aux"][:-1])
        print(f"tree kernels: N={label} path={inp['path']} tile={c.tree_tile} "
              f"src_tile={c.tree_src_tile} max_near={c.tree_max_near} lists {shapes} "
              f"VIP panel {0 if ops['panel'] is None else ops['panel'].shape[0]} bodies; "
              f"{'; '.join(line)}; bitwise-repeatable", flush=True)
        del inp
        if device.type == "cuda":
            torch.cuda.empty_cache()
    timed = [k for k in TREE_KERNELS if "ms" in res[k]]
    if timed:
        print("tree kernels: times (ms/call): " + "; ".join(
            f"{k} at {time_at[k]} {res[k]['ms']:.4f} vs plain {res[k]['plain_ms']:.4f}"
            f" bound {res[k]['bound_ms']:.4f} ({res[k]['bound_by']})"
            + (f" library {res[k]['library_ms']:.4f}" if res[k]["library_ms"] else "")
            for k in timed), flush=True)
    return res


def counters() -> dict:
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode

    return {"allpairs": cuda_force.block_acc, "symmetric": cuda_symmetric.symmetric_acc,
            "near": cuda_treecode.near_field, "far": cuda_treecode.far_field_hier,
            "vip": cuda_treecode.vip_both, "far_single": cuda_treecode.far_field_single,
            "gather": cuda_treecode.gather_panels, "near_panel": cuda_treecode.near_panel}


def launches_a_step(cfg, n: int) -> dict:
    """Kernel launches a treecode step of ``cfg``'s path makes, by wrapper
    (the VIP sweep is its pair kernel and the kernel that sums its
    per-block reactions): hierarchical near, far and VIP; flat near,
    single-level far and VIP; dense gather, near-panel, the single-level
    far field when ``max_near < K``, and VIP."""
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_path

    path = tree_path(cfg)
    want = dict.fromkeys(TREE_KERNELS, 0)
    if path == "dense":
        k, max_near, vip = treecode._static_args(n, cfg.tree_tile, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles)
        want.update(gather=1, near_panel=1, far_single=int(max_near < k))
    else:
        vip = treecode._flat_static(n, cfg.tree_tile, cfg.tree_src_tile, cfg.tree_theta,
                                    cfg.tree_max_near, cfg.tree_vip_tiles)[4]
        want.update({"near": 1, "far" if path == "hier" else "far_single": 1})
    want["vip"] = 2 if vip else 0
    return want


def drive_main_path(device, n: int = N_MAIN, prime: int = PRIME_STEPS,
                    timed: int = TIMED_STEPS) -> None:
    """Phase 5: the default simulation, then solver="pallas", then
    leapfrog, each through the public ``Simulation`` entry point."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    wrappers = counters()
    runs = (
        ("default", SimConfig(), "pallas_symmetric", "symmetric"),
        ("pallas", SimConfig(solver="pallas"), "pallas", "allpairs"),
        ("leapfrog", SimConfig(integrator="leapfrog"), "pallas_symmetric", "symmetric"),
    )
    for label, cfg, solver, key in runs:
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        check(sim.solver == solver, f"{label}: resolved {sim.solver!r}, expected {solver!r}")
        e0 = sim.diagnostics()["energy"]
        sim.run(prime)
        before, wall0 = wrappers[key].launches, sim.wall_seconds
        sim.run(timed)
        launched = wrappers[key].launches - before
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


def tree_force_error(sim, sample: int | None = None,
                     fresh: bool = True) -> tuple[float, float]:
    """(p99, median) relative error of the treecode force on ``sim``'s
    current bodies against the all-pairs kernel's exact force (on
    ``sample`` random real bodies, or on all of them).

    ``fresh``: the bodies re-sorted and the lists built anew, as
    ``bench.py``'s probe does. Otherwise the lists the run last stepped
    with, on the bodies as it left them: ``tree_rebuild_every`` steps after
    the lists were built (after a run of whole chunks), as stale as the
    lists of a leapfrog step get and one step staler than an Euler step's.
    """
    import torch

    from n_body_problem_tpu_torch.ops.registry import make_force_fn, tree_fns
    from n_body_problem_tpu_torch.treecode_profile import force_error
    from n_body_problem_tpu_torch.utils.morton import device_resort

    s = sim.state
    if fresh:
        s, _ = device_resort(s, torch.arange(s.n, device=s.device))
        tree = make_force_fn(sim.cfg, s.device.type, s.n)(s.pos, s.mass)
    else:
        tree = tree_fns(sim.cfg)[1](s.pos, s.mass, sim.tree_lists)
    return force_error(tree, s.pos, s.mass, s.n_real, sim.cfg, sample)


def tree_runs():
    """(label, N, config, timed steps, bodies sampled by the error probe)."""
    from n_body_problem_tpu_torch import SimConfig
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    return (
        ("65k euler", 65536, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("65k leapfrog", 65536, SimConfig(solver="treecode", integrator="leapfrog"),
         TREE_TIMED, None),
        ("20k tuned", 20480, SimConfig(solver="treecode", **tuned_tree_overrides(20480)),
         TREE_TIMED, None),
        ("524k", 524288, SimConfig(solver="treecode"), 16, 2048),
        ("20k flat", 20480, SimConfig(solver="treecode", tree_hier=False), TREE_TIMED, None),
        ("65k flat leapfrog", 65536,
         SimConfig(solver="treecode", tree_hier=False, integrator="leapfrog"),
         TREE_TIMED, None),
        # Flat by N alone. Not 3,072: there K_s = 48 source tiles is no
        # multiple of the 32 entries a chunk, the planner clamps max_near to
        # 32 below the 41 tiles rows open, and the JAX package's own force
        # misses the envelope (p99 1.4e-2; ROADMAP §3).
        ("2.5k default", 2560, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("1k default", 1024, SimConfig(solver="treecode"), TREE_TIMED, None),
        ("20k dense", 20480, SimConfig(solver="treecode", tree_flat_cap=-1), TREE_TIMED, None),
    )


PROFILED = ("65k euler", "20k flat", "20k dense")


def drive_treecode(device, runs=None, profiled=PROFILED) -> dict:
    """Phase 6: the treecode main path through ``Simulation``; returns the
    launch counts of the runs (the error probes are not counted)."""
    import torch

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.ops.registry import tree_path
    from n_body_problem_tpu_torch.treecode_profile import profile_tree_step

    wrappers = counters()
    launched = {k: 0 for k in TREE_KERNELS}
    for label, n, cfg, timed, sample in runs or tree_runs():
        t0 = time.perf_counter()
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        e0 = sim.diagnostics()["energy"]
        before = {k: wrappers[k].launches for k in TREE_KERNELS}
        sim.run(TREE_PRIME)
        wall0 = sim.wall_seconds
        sim.run(timed)
        wall = sim.wall_seconds - wall0
        moved = {k: wrappers[k].launches - before[k] for k in TREE_KERNELS}
        per_step = launches_a_step(sim.cfg, sim.state.n)
        for k in TREE_KERNELS:   # (a CPU rehearsal runs the plain versions)
            want = per_step[k] * (TREE_PRIME + timed) if device.type == "cuda" else 0
            check(moved[k] == want,
                  f"treecode [{label}]: {k} launches {moved[k]}, expected {want}")
            launched[k] += moved[k]
        check(bool(torch.isfinite(sim.state.pos).all()), f"treecode [{label}]: non-finite positions")
        d = sim.diagnostics()
        check(d["overspeed"] == 0, f"treecode [{label}]: overspeed {d['overspeed']}")
        check(d["step"] == TREE_PRIME + timed, f"treecode [{label}]: step {d['step']}")
        # The envelope holds on fresh lists, as the JAX package's tests and
        # bench.py measure it; the error on the run's own lists, as stale
        # as the run lets them get, is reported beside it (PERF.md §6).
        errs = {lists: tree_force_error(sim, sample, fresh=fresh)
                for lists, fresh in (("fresh lists", True), ("the run's lists", False))}
        p99, med = errs["fresh lists"]
        check(p99 < ERR_P99 and med < ERR_MEDIAN,
              f"treecode [{label}]: force error p99 {p99:.3e} median {med:.3e}")
        check(all(map(math.isfinite, errs["the run's lists"])),
              f"treecode [{label}]: non-finite error on the run's lists")
        c = sim.cfg
        print(f"treecode [{label}]: N={sim.state.n_real} path={tree_path(c)} tile={c.tree_tile} "
              f"src_tile={c.tree_src_tile} vip={c.tree_vip_tiles} caps(max_near="
              f"{c.tree_max_near} flat={c.tree_flat_cap} far_max={c.tree_far_max} "
              f"far={c.tree_far_cap}) rebuild_every={c.tree_rebuild_every} "
              f"integrator={c.integrator} init {init_s:.3f} s; "
              f"{wall / timed * 1e3:.4f} ms/step over {timed} steps "
              f"{sim.pairs_per_step() * timed / wall:.4e} pairs/s; launches "
              f"{ {k: v for k, v in moved.items() if v} }; |dE/E| after {TREE_PRIME + timed} steps "
              f"{abs((d['energy'] - e0) / e0):.3e}; force error vs all-pairs on "
              f"{sample or sim.state.n_real} bodies: " + "; ".join(
                  f"{lists} p99 {p99:.3e} median {med:.3e}"
                  for lists, (p99, med) in errs.items()), flush=True)
        if label in profiled:
            prof = profile_tree_step(sim)
            print(f"treecode profile [{label}, 16 steps, ms]: " + " ".join(
                f"{k} {v:.4f}" for k, v in prof.items()), flush=True)
        del sim
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return launched


def energy_check(device) -> None:
    """Phase 7: the JAX package's energy-drift test, through the
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


def run_cli(out: pathlib.Path, n: int = 20480, device: str | None = None,
            extra: tuple[str, ...] = ()) -> None:
    """Phase 8: the CLI's ``run`` subcommand in a subprocess."""
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "n_body_problem_tpu_torch", "run",
           "--model", "galaxy_collision", "--n", str(n), "--steps", "20",
           "--diag-every", "10", "--out", str(out), *extra]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stderr.splitlines():
        print(f"  cli| {line}")
    check(proc.returncode == 0, f"cli {' '.join(extra)}: rc={proc.returncode}")
    state, _ = load_checkpoint(out / "final.npz")
    check(int(state.step) == 20, f"cli: final.npz at step {int(state.step)}")
    check(bool(state.pos.isfinite().all()), "cli: non-finite positions in final.npz")
    print(f"cli {' '.join(extra) or '(default solver)'}: rc 0, final.npz with "
          f"{state.n_real} bodies at step 20", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    from n_body_problem_tpu_torch.ops import cuda_build

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
    res.update(compare_tree_kernels(device))

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    drive_main_path(device)
    launches = {k: wrappers[k].launches for k in ("allpairs", "symmetric")}
    for w in wrappers.values():
        w.launches = 0
    launches.update(drive_treecode(device))
    for key, count in launches.items():
        check(count > 0, f"main path never launched the {key} kernel")
    energy_check(device)
    run_cli(ROOT / "out" / "chip_smoke_cli")
    run_cli(ROOT / "out" / "chip_smoke_cli_tree",
            extra=("--solver", "treecode", "--tree-tuned"))

    records = (
        ("allpairs", "allpairs_acc_kernel", "allpairs.cu", "pallas_force.py:41"),
        ("symmetric", "symmetric_acc_kernel", "symmetric.cu", "pallas_symmetric.py:87"),
        ("far_single", "far_single_kernel", "far_single.cu", "treecode.py:436"),
        ("gather", "gather_panels_kernel", "gather.cu", "treecode.py:617"),
        ("near_panel", "near_panel_kernel", "near_panel.cu", "treecode.py:718"),
        ("vip", "vip_both_kernel+vip_react_sum_kernel", "vip.cu", "treecode.py:805"),
        ("near", "near_field_kernel", "near.cu", "treecode.py:1286"),
        ("far", "far_field_kernel", "far_hier.cu", "treecode.py:2164"),
    )
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"n_body_problem_tpu_torch/csrc/{src}",
         "replaces": f"n_body_problem_tpu/ops/{tpu}",
         "launches": launches[key], **res[key]}
        for key, name, src, tpu in records]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
