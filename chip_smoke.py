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
   bodies) and 65,536, and at K = 1, 3 and 5 (odd, 60 padding bodies) of the
   symmetric kernel's own 512-body tile (N = 512, 1,536, 2,560; 1,024 is
   K = 2), within rtol=1e-4, atol=2e-6; the all-pairs kernel also in block
   form and for bitwise repeatability; the symmetric kernel for momentum
   (|sum m a| < 1e-6, < 1e-7 at 65,536), and at N = 448 with tile 64 (its
   wrapper pads to 512). Times both at N = 65,536, and once each at 262,144,
   where the two must agree within 1e-4 a body. Then the all-pairs kernel's
   splits: at 384 x 65,536, 2,048 x 65,536 and x 524,288 (the error probe's
   shape), 16,384 x 65,536 (a four-way ring's), 8,192 and 32,768 squared, the
   split its schedule chooses (several column pieces, two launches) and
   others (one piece; 1, 2, 4 and 8 parts), each against the plain version
   and twice for bitwise equality; timed at 8,192 squared and at
   2,048 x 524,288. Then the bf16x3/mixed kernel against its twin
   in both modes at N = 512 and 448 (tile 64), 1,024 (934 real, tile 512)
   and 65,536 (tile 512): |kernel - twin| / |twin - f32 twin| <= 0.3 and a
   per-body p99 <= 1.5e-5 ("mixed" with K <= 3 tiles is the f32 mode and
   matches the f32 kernel within rtol=1e-4, atol=2e-6); each mode's error
   against the all-pairs kernel inside the JAX envelopes, mixed no worse
   than bf16x3. Times both modes at 65,536.
4. treecode kernels: every treecode kernel against its plain version on
   the port's own work lists, at the shapes of every treecode run of phase
   6 and one smaller: the hierarchical path (near, far, VIP) on Plummer
   spheres of 8,192, 20,480 (with ``tuned_tree_overrides``: 32-body source
   tiles, so 64 entries fill the near kernel's 2,048-body stage), 65,536
   and 524,288 bodies; the single-level flat path (near at 32-body rows,
   single-level far, VIP) at 20,480 and 65,536 with ``tree_hier=False`` and
   at 2,560; the dense path (gather, near-panel, single-level far, VIP) at
   1,024 (every tile near, so no far field) and at 20,480 with
   ``tree_flat_cap=-1``; and the near kernel's other block splits, target
   rows of 64 and 256 bodies at 65,536 (``tree_tile``). Within rtol=1e-4,
   atol=2e-6 on the raw outputs, the gather exactly; each launch repeated
   for bitwise equality. Times each kernel at the largest shape of its
   path, beside its plain version, its bound, its issue floor and (the
   gather) one ``index_select`` call; the near kernel at every row size,
   with the largest and the mean number of chunks a row; the VIP sweep and
   the far field also at 524,288, the single-level far field also at 20,480
   dense and the near-panel kernel also at 1,024; these four each with its
   kernels' device time from a ``torch.profiler`` trace (the sweep is a
   pair and a summing kernel).
5. exact main path: ``Simulation(SimConfig(), plummer(65536))`` (the
   symmetric kernel), ``solver="pallas"`` (the all-pairs kernel), leapfrog,
   and ``pallas_sym_precision="bf16x3"`` and ``"mixed"`` (the tensor-core
   kernel); launch counters show that each run launched its kernel every
   step and no other. Then the pair-matrix foil (plain PyTorch) at 4,096
   against the all-pairs kernel's force.
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
card's name and power limit, and ``{"ok": true, "device": {...}}``. The
records of every kernel but the gather also carry ``issue_floor_ms``
(``kernel_compare.issue_floor_ms`` at the SM clock of this run); those of
the VIP sweep, the two far fields and the near-panel kernel ``device_ms``
and their second shape's record (``at_524288``, ``at_20480_dense``,
``at_1024``).
"""

from __future__ import annotations

import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

from n_body_problem_tpu_torch.kernel_compare import (PAIR_BOTH_FLOPS, PAIR_BOTH_SLOTS,
                                                      PAIR_FLOPS, PAIR_SLOTS, PHYS, TREE_WORK,
                                                      bound, fast_bound, fast_issue_floor_ms,
                                                      issue_floor_ms, kernel_ms, near_work,
                                                      sm_clock_mhz, tree_bound)

ROOT = pathlib.Path(__file__).resolve().parent
TOL = dict(rtol=1e-4, atol=2e-6)
# (padded N, real N): one tile, odd tile count, padding bodies, full size.
SIZES = ((128, 128), (896, 896), (1024, 934), (65536, 65536),
         (512, 512), (1536, 1536), (2560, 2500))
N_MAIN, N_LARGE = 65536, 262144
PRIME_STEPS, TIMED_STEPS = 5, 20
TREE_PRIME, TREE_TIMED = 8, 64
ERR_P99, ERR_MEDIAN = 2.5e-3, 5e-4   # tests/test_treecode_hier.py:126-127
TREE_KERNELS = ("near", "far", "vip", "far_single", "gather", "near_panel")
# FP32 operations a kernel does per interaction, an FMA counted as two and an
# rsqrt as one (a body against a node's monopole + quadrupole; a body pair one
# way and both ways), the issue slots each takes, the peak rates, ``bound``
# and the physics of every check (PHYS) are ``kernel_compare``'s.
# (padded N, real N, tile) of the fast modes' check: even K = 8 (the JAX
# test's shape), odd K = 7, padding with K = 2, and the production size.
FAST_SIZES = ((512, 512, 64), (448, 448, 64), (1024, 934, 512), (65536, 65536, 512))
FAST_RATIO = 0.3   # |kernel - twin| / |twin - f32 twin|
FAST_P99_VS_TWIN = 1.5e-5   # per-body relative kernel - twin difference
# JAX envelopes of the fast modes against the direct sum, (p99, median)
# (tests/test_pallas_symmetric.py:54-63).
FAST_ENVELOPE = {"bf16x3": (3e-2, 4e-3), "mixed": (5e-3, 5e-4)}


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

    tiles = dict(tile_i=128, tile_j=128)
    res = {"allpairs": {"max_abs_err": 0.0}, "symmetric": {"max_abs_err": 0.0}}
    for n, n_real in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        # The twin's tile (any divisor of N: the f32 sum is the same up to
        # rounding); the kernel tiles by 512 whatever the caller names.
        tile = cuda_symmetric.KERNEL_TILE if n % cuda_symmetric.KERNEL_TILE == 0 else 128
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
        limit = 1e-7 if n == N_MAIN else 1e-6
        check(net < limit, f"symmetric N={n}: |sum m a| = {net:.3e} >= {limit}")
        torch.cuda.synchronize(device)  # a fault in the run shows here
        print(f"kernels: N={n} (real {n_real}) allpairs err {ea:.3e} "
              f"block(384x{n}) err {eb:.3e} bitwise-repeatable; symmetric "
              f"(K={-(-n // cuda_symmetric.KERNEL_TILE)}) err {es:.3e} |sum m a| {net:.3e}",
              flush=True)

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
            clock = sm_clock_mhz()
            res["allpairs"].update(library_ms=None, **bound(PAIR_FLOPS * n * n, nbytes),
                                   issue_floor_ms=issue_floor_ms(n * n, PAIR_SLOTS, clock))
            res["symmetric"].update(
                library_ms=None, **bound(PAIR_BOTH_FLOPS * n * (n - 1) // 2, nbytes),
                issue_floor_ms=issue_floor_ms(n * (n - 1) / 2, PAIR_BOTH_SLOTS, clock))
            print("kernels: times at N={} (ms/call) allpairs {:.4f} vs plain {:.4f}, bound "
                  "{:.4f}, issue floor {:.4f}; symmetric {:.4f} vs plain {:.4f}, bound {:.4f}, "
                  "issue floor {:.4f} at {:.0f} MHz".format(
                      n, res["allpairs"]["ms"], res["allpairs"]["plain_ms"],
                      res["allpairs"]["bound_ms"], res["allpairs"]["issue_floor_ms"],
                      res["symmetric"]["ms"], res["symmetric"]["plain_ms"],
                      res["symmetric"]["bound_ms"], res["symmetric"]["issue_floor_ms"],
                      clock), flush=True)
    if time_at is not None:
        # The largest size `auto` gives the symmetric kernel: once each,
        # beside the all-pairs kernel, which has to agree with it.
        s = cloud(N_LARGE, N_LARGE, seed=N_LARGE, device=device)
        ap = lambda: cuda_force.block_acc(s.pos, s.pos, s.mass, **tiles, **PHYS)  # noqa: E731
        sy = lambda: cuda_symmetric.symmetric_acc(s.pos, s.mass, **PHYS)  # noqa: E731
        diff = float(rel_err(sy(), ap(), N_LARGE).max())
        check(diff < 1e-4, f"symmetric N={N_LARGE}: {diff:.3e} a body from the all-pairs kernel")
        res["symmetric"]["ms_262144"] = time_ms(sy, 1)
        res["allpairs"]["ms_262144"] = time_ms(ap, 1)
        print(f"kernels: N={N_LARGE} symmetric {res['symmetric']['ms_262144']:.4f} ms, allpairs "
              f"{res['allpairs']['ms_262144']:.4f} ms, largest difference a body {diff:.3e}",
              flush=True)
        del s
        torch.cuda.empty_cache()
    # N = 448 with tile 64: the JAX package takes it; the f32 kernel's
    # wrapper pads to its 512-body tile with zero-mass bodies.
    s = cloud(448, 448, seed=448, device=device)
    e = agree(res, "symmetric", "symmetric N=448 tile 64",
              cuda_symmetric.symmetric_acc(s.pos, s.mass, tile=64, **PHYS),
              cuda_symmetric.symmetric_acc_plain(s.pos, s.mass, tile=64, **PHYS))
    torch.cuda.synchronize(device)
    print(f"kernels: symmetric N=448 tile 64 (padded to 512 inside) err {e:.3e}", flush=True)
    return res


# (Ni, Nj) of the all-pairs kernel's block form: a few rows, the treecode
# error probe's 2,048 sampled rows at 65,536 and 524,288, a four-way ring's
# share of 65,536, and the square cases whose rows alone do not fill the card.
ALLPAIRS_BLOCKS = ((384, 65536), (2048, 65536), (2048, 524288), (16384, 65536),
                   (8192, 8192), (32768, 32768))
ALLPAIRS_TIMED = ((8192, 8192), (2048, 524288))


def compare_allpairs_splits(device, res: dict, shapes=ALLPAIRS_BLOCKS,
                            timed=ALLPAIRS_TIMED) -> None:
    """Phase 3, the all-pairs kernel's splits: at each (Ni, Nj) the split the
    schedule chooses, the same rows in one piece, and other parts and
    pieces, each against the plain version, twice for bitwise equality, with
    the launches the split says (one, or two with several pieces). Times the
    chosen split at the shapes of ``timed`` into ``res["allpairs"]``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force as cf
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    rule = cf.allpairs_split
    tiles = dict(tile_i=128, tile_j=128)
    try:
        for ni, nj in shapes:
            s = cloud(nj, nj, seed=nj, device=device)
            gen = torch.Generator(device="cpu").manual_seed(0)
            rows = (s.pos if ni == nj else
                    s.pos[torch.randperm(nj, generator=gen)[:ni].sort().values.to(device)])
            want = cf.block_acc_plain(rows, s.pos, s.mass, **PHYS)
            chosen = rule(ni, nj)
            stages = -(-nj // cf.ALLPAIRS_STAGE)
            others = [(128, 8, 1), (128, 8, min(stages, 3)), (256, 4, min(stages, 7)),
                      (512, 2, min(stages, 2)), (1024, 1, stages)]
            seen = []
            for split in [chosen] + [o for o in others if o != chosen]:
                cf.allpairs_split = lambda *_, split=split: split
                before = cf.block_acc.launches
                got = cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS)
                launched = cf.block_acc.launches - before
                check(launched == (2 if split[2] > 1 else 1),
                      f"allpairs {ni}x{nj} split {split}: {launched} launches")
                err = agree(res, "allpairs", f"allpairs {ni}x{nj} split {split}", got, want)
                check(torch.equal(got, cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS)),
                      f"allpairs {ni}x{nj} split {split}: two launches differ bitwise")
                seen.append(f"{'x'.join(map(str, split))} err {err:.2e}")
            cf.allpairs_split = rule
            check(chosen[2] > 1, f"allpairs {ni}x{nj}: the rule cut no column pieces")
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # a fault in the run shows here
            line = (f"kernels: allpairs block {ni}x{nj} rule {'x'.join(map(str, chosen))} "
                    f"(rows x parts x pieces); {'; '.join(seen)}; bitwise-repeatable")
            if (ni, nj) in timed:
                ms = time_ms(lambda: cf.block_acc(rows, s.pos, s.mass, **tiles, **PHYS), 20)
                clock = sm_clock_mhz()
                floor = issue_floor_ms(ni * nj, PAIR_SLOTS, clock)
                res["allpairs"][f"ms_{ni}x{nj}"] = ms
                res["allpairs"][f"issue_floor_ms_{ni}x{nj}"] = floor
                ops = bound(PAIR_FLOPS * ni * nj, (ni * 6 + nj * 4) * 4)["bound_ms"]
                line += (f"; {ms:.4f} ms, bound {ops:.4f}, issue floor {floor:.4f} at "
                         f"{clock:.0f} MHz")
            print(line, flush=True)
            del s, rows, want, got
            torch.cuda.empty_cache()
    finally:
        cf.allpairs_split = rule


def rel_err(got, want, n_real: int):
    """Per-body relative force difference over the real bodies."""
    import torch

    d = (got - want)[:n_real].norm(dim=1)
    return d / torch.clamp(want[:n_real].norm(dim=1), min=1e-12)


def compare_fast(device, sizes=FAST_SIZES, time_at: int | None = N_MAIN) -> dict:
    """Phase 3, the fast modes: ``symmetric_bf16x3_kernel`` against its twin
    in "bf16x3" and "mixed" (distance ratio, per-body p99), each mode's
    error against the all-pairs kernel inside the JAX envelopes, mixed no
    worse than bf16x3; times at ``time_at`` bodies beside the f32 kernel."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    res = {"max_abs_err": 0.0}
    for n, n_real, tile in sizes:
        s = cloud(n, n_real, seed=n, device=device)
        pos, mass = s.pos, s.mass
        kw = dict(tile=tile, **PHYS)
        exact = cuda_force.block_acc(pos, pos, mass, tile_i=64, tile_j=64, **PHYS)
        f32_twin = cuda_symmetric.symmetric_acc_plain(pos, mass, **kw)
        f32_kernel = cuda_symmetric.symmetric_acc(pos, mass, **kw)
        k = n // tile
        p99 = {}
        for prec in ("bf16x3", "mixed"):
            got = cuda_symmetric.symmetric_acc(pos, mass, precision=prec, **kw)
            twin = cuda_symmetric.symmetric_acc_plain(pos, mass, precision=prec, **kw)
            torch.cuda.synchronize(device)
            check(bool(torch.isfinite(got).all()), f"{prec} N={n}: non-finite output")
            res["max_abs_err"] = max(res["max_abs_err"], float((got - twin).abs().max()))
            diff = rel_err(got, twin, n_real)
            d99 = float(torch.quantile(diff, 0.99))
            if prec == "mixed" and k <= 3:
                # No fast diagonal: "mixed" is the f32 mode.
                check(torch.allclose(got, f32_kernel, **TOL),
                      f"mixed N={n} (K={k}): outside rtol=1e-4, atol=2e-6 of the f32 kernel")
                what = "= f32 kernel"
            else:
                ratio = float((got - twin).norm() / (twin - f32_twin).norm())
                check(ratio <= FAST_RATIO, f"{prec} N={n}: |kernel - twin| / |twin - f32 twin|"
                      f" = {ratio:.3f} > {FAST_RATIO}")
                what = f"ratio {ratio:.3f}"
            check(d99 <= FAST_P99_VS_TWIN,
                  f"{prec} N={n}: per-body p99 vs twin {d99:.3e} > {FAST_P99_VS_TWIN}")
            # Which side's float32 sums set the ratio: the kernel's and the
            # twin's distances from the same mode in float64, over the mode's
            # distance from f32.
            t64 = cuda_symmetric.symmetric_acc_plain(pos.double(), mass.double(),
                                                     precision=prec, **kw).float()
            scale = float((twin - f32_twin).norm())
            noise = (float((got - t64).norm()) / scale, float((twin - t64).norm()) / scale)
            del t64
            err = rel_err(got, exact, n_real)
            p99[prec], med = float(torch.quantile(err, 0.99)), float(err.median())
            env = FAST_ENVELOPE[prec]
            check(p99[prec] < env[0] and med < env[1],
                  f"{prec} N={n}: p99 {p99[prec]:.3e} median {med:.3e} outside {env}")
            net = float((mass[:, None] * got).sum(0).abs().max())
            print(f"fast kernels: N={n} (real {n_real}) tile {tile} {prec}: vs twin {what} "
                  f"p99 {d99:.3e} max |d| {float((got - twin).abs().max()):.3e}; vs float64 "
                  f"kernel {noise[0]:.3f} twin {noise[1]:.3f}; vs all-pairs "
                  f"p99 {p99[prec]:.3e} median {med:.3e}; |sum m a| {net:.3e}", flush=True)
            if n == time_at:
                fn = lambda: cuda_symmetric.symmetric_acc(pos, mass, precision=prec, **kw)  # noqa: E731
                res[prec] = {"ms": time_ms(fn, 20),
                             "plain_ms": time_ms(lambda: cuda_symmetric.symmetric_acc_plain(
                                 pos, mass, precision=prec, **kw), 3),
                             "p99": p99[prec], "median": med, **fast_bound(n, tile, prec),
                             "issue_floor_ms": fast_issue_floor_ms(n, tile, prec,
                                                                   sm_clock_mhz())}
        check(p99["mixed"] <= p99["bf16x3"],
              f"N={n}: mixed p99 {p99['mixed']:.3e} > bf16x3 {p99['bf16x3']:.3e}")
        del s, pos, mass, exact, f32_twin, f32_kernel
        torch.cuda.empty_cache()
    if time_at in [n for n, _, _ in sizes]:
        print(f"fast kernels: times at N={time_at} tile 512 (ms/call): " + "; ".join(
            f"{p} {res[p]['ms']:.4f} vs plain {res[p]['plain_ms']:.4f} bound "
            f"{res[p]['bound_ms']:.4f} ({res[p]['bound_by']}) issue floor "
            f"{res[p]['issue_floor_ms']:.4f}" for p in ("bf16x3", "mixed")),
            flush=True)
    return res


def tree_kernel_cases():
    """(label, N, overrides): the shapes of every treecode run of phase 6,
    and a smaller one."""
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    return (("8,192", 8192, {}), ("20,480 tuned", 20480, tuned_tree_overrides(20480)),
            ("65,536", 65536, {}), ("524,288", 524288, {}),
            ("65,536 rows of 64", 65536, dict(tree_tile=64)),
            ("65,536 rows of 256", 65536, dict(tree_tile=256)),
            ("20,480 flat", 20480, dict(tree_hier=False)),
            ("65,536 flat", 65536, dict(tree_hier=False)),
            ("2,560", 2560, {}), ("1,024", 1024, {}),
            ("20,480 dense", 20480, dict(tree_flat_cap=-1)))


def time_near(kernel, args, kw) -> dict:
    """The near kernel's time at one shape beside its bound, its issue floor
    at this run's SM clock, and the largest and mean number of chunks a
    target row has."""
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    work = near_work(args, kw)
    work.pop("pairs")
    ms = time_ms(lambda: kernel(*args, **kw), 20)
    return {"ms": ms, **tree_work("near", args, kw), **work}


def tree_work(key: str, args, kw) -> dict:
    """``bound`` of a treecode kernel's call, counting the interactions
    these inputs need (sentinel entries and masked tiles are skipped) and
    each input read and each output written once, and its issue floor at
    this run's SM clock: a pair one way ``PAIR_SLOTS``, and the VIP pairs
    and body-node terms at the slots of ``kernel_compare.TREE_WORK`` (the
    gather has none: it moves bytes)."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    if key == "near":
        count, slots = near_work(args, kw)["pairs"], PAIR_SLOTS
        out = bound(PAIR_FLOPS * count, nbytes + kw["n"] * 12)
    elif key == "gather":
        bodies, near_idx = args
        return {**bound(0, nbytes + near_idx.numel() * kw["tile"] * 16), "issue_floor_ms": None}
    else:
        work_fn, count_key, slots = TREE_WORK[key]
        count, out = work_fn(args, kw)[count_key], tree_bound(key, args, kw)
    return {**out, "issue_floor_ms": issue_floor_ms(count, slots, sm_clock_mhz())}


def gather_library(bodies, near_idx, *, tile: int):
    """One PyTorch call computing the gather: ``index_select`` of the
    (K + 1, T, 4) tile view (timed as the gather's yardstick only)."""
    tiles = bodies.view(-1, tile, 4)
    return tiles.index_select(0, near_idx.reshape(-1)).view(near_idx.shape[0], -1, 4)


# Where each treecode kernel is timed (case labels of ``tree_kernel_cases``):
# the main record at the largest shape of the path it serves below 524,288;
# the VIP sweep and the far field also at 524,288, where the card, not the
# host, sets the step's pace; the single-level far field also at 20,480
# dense (its fewest threads), the near-panel kernel also at 1,024 (the
# dense path N alone chooses).
TIME_AT = {"near": ("65,536",), "far": ("65,536", "524,288"), "vip": ("65,536", "524,288"),
           "far_single": ("65,536 flat", "20,480 dense"), "gather": ("20,480 dense",),
           "near_panel": ("20,480 dense", "1,024")}
# The kernels also timed by their device time from a profiler trace: the
# host enqueues these calls more slowly than the card runs them at some of
# their shapes.
DEVICE_TIMED = ("vip", "far", "far_single", "near_panel")


def at_key(label: str) -> str:
    """The record key of a kernel's time at a further shape, ``at_524288``
    or ``at_20480_dense``."""
    return "at_" + label.replace(",", "").replace(" ", "_")


def compare_tree_kernels(device, cases=None, time_at: dict | None = None) -> dict:
    """Phase 4: each treecode kernel against its plain version on the
    port's work lists (the gather exactly); bitwise repeatability; times,
    bounds and the gather's library call at the shapes of ``time_at``."""
    import torch

    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import kernel_inputs, time_ms

    fns = {"near": (ct.near_field, ct.near_field_plain),
           "far": (ct.far_field_hier, ct.far_field_hier_plain),
           "vip": (ct.vip_both, ct.vip_both_plain),
           "far_single": (ct.far_field_single, ct.far_field_single_plain),
           "gather": (ct.gather_panels, ct.gather_panels_plain),
           "near_panel": (ct.near_panel, ct.near_panel_plain)}
    time_at = TIME_AT if time_at is None else time_at
    res = {k: {"max_abs_err": 0.0} for k in TREE_KERNELS}
    for label, n, overrides in cases or tree_kernel_cases():
        inp = kernel_inputs(n, device, **overrides)
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
            if key == "near" and n == N_MAIN and device.type == "cuda":
                t = time_near(kernel, args, kw)
                res["near"].setdefault("by_rows", {})[f"{inp['path']} {kw['tile']}"] = t
                line.append("near at rows of {} {:.4f} ms, bound {:.4f}, issue floor {:.4f}, "
                            "chunks a row max {} mean {:.2f}".format(
                                kw["tile"], t["ms"], t["bound_ms"], t["issue_floor_ms"],
                                t["chunks_max"], t["chunks_mean"]))
            labels = time_at.get(key, ())
            if label in labels:
                t = {"ms": time_ms(lambda: kernel(*args, **kw), 20)}
                if key in DEVICE_TIMED:   # the kernels alone, without the host's enqueue
                    t["by_kernel_ms"] = kernel_ms(lambda: kernel(*args, **kw), 20)
                    t["device_ms"] = sum(t["by_kernel_ms"].values())
                t.update(tree_work(key, args, kw))
                if label == labels[0]:
                    t["plain_ms"] = time_ms(lambda: plain(*args, **kw), 3)
                    t["library_ms"] = None
                    if key == "gather":
                        check(torch.equal(gather_library(*args, **kw), got),
                              f"gather N={label}: index_select != kernel")
                        t["library_ms"] = time_ms(lambda: gather_library(*args, **kw), 20)
                    res[key].update(t)
                else:
                    res[key][at_key(label)] = t
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
            f"{k} at {time_at[k][0]} {res[k]['ms']:.4f} vs plain {res[k]['plain_ms']:.4f}"
            f" bound {res[k]['bound_ms']:.4f} ({res[k]['bound_by']})"
            + (f" issue floor {res[k]['issue_floor_ms']:.4f}" if res[k]["issue_floor_ms"]
               else "")
            + (f" library {res[k]['library_ms']:.4f}" if res[k]["library_ms"] else "")
            for k in timed), flush=True)
    for k in DEVICE_TIMED:
        for label in time_at.get(k, ()):
            t = res[k] if label == time_at[k][0] else res[k].get(at_key(label))
            if t and "device_ms" in t:
                print(f"tree kernels: {k} at {label}: call {t['ms']:.4f} ms, kernels "
                      + " + ".join(f"{name} {ms:.4f}" for name, ms in t["by_kernel_ms"].items())
                      + f" = {t['device_ms']:.4f} ms; bound {t['bound_ms']:.4f}, issue floor "
                      f"{t['issue_floor_ms']:.4f}", flush=True)
    return res


def counters() -> dict:
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode

    return {"allpairs": cuda_force.block_acc, "symmetric": cuda_symmetric.symmetric_acc,
            "symmetric_bf16x3": cuda_symmetric.symmetric_acc_bf16x3,
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
    """Phase 5: the default simulation, then solver="pallas", leapfrog, and
    the symmetric solver's "bf16x3" and "mixed" precisions, each through
    the public ``Simulation`` entry point; each run launches its kernel as
    often a step as its schedule says (once) and no other kernel."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    from n_body_problem_tpu_torch.ops.cuda_force import allpairs_split

    wrappers = counters()
    # Kernel launches a force: the all-pairs kernel is one with one column
    # piece, two with several; every other exact solver is one kernel.
    a_force = {"allpairs": 2 if allpairs_split(n, n)[2] > 1 else 1}
    runs = (
        ("default", SimConfig(), "pallas_symmetric", "symmetric"),
        ("pallas", SimConfig(solver="pallas"), "pallas", "allpairs"),
        ("leapfrog", SimConfig(integrator="leapfrog"), "pallas_symmetric", "symmetric"),
        ("bf16x3", SimConfig(pallas_sym_precision="bf16x3"), "pallas_symmetric",
         "symmetric_bf16x3"),
        ("mixed", SimConfig(pallas_sym_precision="mixed"), "pallas_symmetric",
         "symmetric_bf16x3"),
    )
    for label, cfg, solver, key in runs:
        sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
        check(sim.solver == solver, f"{label}: resolved {sim.solver!r}, expected {solver!r}")
        e0 = sim.diagnostics()["energy"]
        start = {k: w.launches for k, w in wrappers.items()}
        sim.run(prime)
        before, wall0 = wrappers[key].launches, sim.wall_seconds
        sim.run(timed)
        launched = wrappers[key].launches - before
        wall = sim.wall_seconds - wall0
        want = a_force.get(key, 1) * timed
        check(launched == want,
              f"{label}: kernel launched {launched} times in {timed} steps, expected {want}")
        others = {k: w.launches - start[k] for k, w in wrappers.items() if k != key}
        check(not any(others.values()), f"{label}: other kernels launched: {others}")
        check(bool(torch.isfinite(sim.state.pos).all()), f"{label}: non-finite positions")
        d = sim.diagnostics()
        check(d["overspeed"] == 0, f"{label}: overspeed {d['overspeed']}")
        check(d["step"] == prime + timed, f"{label}: step {d['step']}")
        ms = wall / timed * 1e3
        print(f"main path [{label}]: N={sim.state.n_real} solver={sim.solver} "
              f"precision={cfg.pallas_sym_precision} integrator={cfg.integrator} "
              f"{ms:.4f} ms/step {sim.pairs_per_step() * timed / wall:.4e} pairs/s "
              f"launches {launched} |dE/E| after {prime + timed} steps "
              f"{abs((d['energy'] - e0) / e0):.3e}", flush=True)


def drive_pair_matrix(device, n: int = 4096, steps: int = 10) -> None:
    """Phase 5, the pair-matrix foil (plain PyTorch, no kernel of its own):
    its force against the all-pairs kernel's, then ``steps`` timed steps."""
    import torch

    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_force
    from n_body_problem_tpu_torch.ops.registry import make_force_fn

    cfg = SimConfig(solver="pair_matrix")
    sim = Simulation(cfg, models.plummer(n, seed=0), device=device)
    check(sim.solver == "pair_matrix" and sim.state.n == n, "pair_matrix: solver or padding")
    s = sim.state
    got = make_force_fn(cfg, device.type, s.n)(s.pos, s.mass)
    want = cuda_force.block_acc(s.pos, s.pos, s.mass, tile_i=128, tile_j=128, **PHYS)
    check(torch.allclose(got, want, **TOL),
          f"pair_matrix: force outside rtol=1e-4, atol=2e-6 of the all-pairs kernel "
          f"(max |d| {float((got - want).abs().max()):.3e})")
    sim.run(2)
    wall0 = sim.wall_seconds
    sim.run(steps)
    wall = sim.wall_seconds - wall0
    check(bool(torch.isfinite(sim.state.pos).all()), "pair_matrix: non-finite positions")
    print(f"main path [pair_matrix]: N={n} plain PyTorch {wall / steps * 1e3:.4f} ms/step "
          f"{sim.pairs_per_step() * steps / wall:.4e} pairs/s; force vs all-pairs max |d| "
          f"{float((got - want).abs().max()):.3e}", flush=True)


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
    compare_allpairs_splits(device, res)
    fast = compare_fast(device)
    print(f"kernels: symmetric at N={N_MAIN}: f32 {res['symmetric']['ms']:.4f} ms, bf16x3 "
          f"{fast['bf16x3']['ms']:.4f}, mixed {fast['mixed']['ms']:.4f}", flush=True)
    res["symmetric_bf16x3"] = {
        "max_abs_err": fast["max_abs_err"], "library_ms": None,
        **{k: fast["bf16x3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "issue_floor_ms")},
        **{f"{k}_mixed": fast["mixed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "issue_floor_ms")}}
    res.update(compare_tree_kernels(device))

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    drive_main_path(device)
    launches = {k: wrappers[k].launches for k in ("allpairs", "symmetric", "symmetric_bf16x3")}
    drive_pair_matrix(device)
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
        ("symmetric_bf16x3", "symmetric_bf16x3_kernel", "symmetric_bf16x3.cu",
         "pallas_symmetric.py:87"),
        ("far_single", "far_single_kernel", "far_single.cu", "treecode.py:436"),
        ("gather", "gather_panels_kernel", "gather.cu", "treecode.py:617"),
        ("near_panel", "near_panel_kernel", "near_panel.cu", "treecode.py:718"),
        ("vip", "vip_both_kernel+vip_sum_kernel", "vip.cu", "treecode.py:805"),
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
