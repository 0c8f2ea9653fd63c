"""The pair kernels timed on one GPU at the main paths' shapes, beside another
checkout's versions of them: the all-pairs kernel (square and block form),
the symmetric f32 kernel, the symmetric bf16x3/mixed kernel, and the
treecode near kernel, VIP sweep, hierarchical far field, single-level far
field and near-panel kernel.

    python -m n_body_problem_tpu_torch.kernel_compare [--before ROOT] [--sweep]
        [--sizes 8192,32768,65536,262144] [--blocks 2048x524288,16384x65536]
        [--fast-small 512:64,448:64,1024:512]
        [--near 65536,524288,20480f,65536f,20480t] [--vip 65536,524288,20480t]
        [--far 65536,524288,20480t] [--far-single 65536f,20480d,2560f]
        [--near-panel 20480d,1024d] [--cap 524288,1048576]
        [--divergence 65536:200,1000] [--json PATH]

For each size the symmetric f32 kernel is timed beside the all-pairs kernel
and held against it, the all-pairs kernel is run twice for bitwise equality,
and the bf16x3/mixed kernel is timed in both modes (tile 512; and at the
small ``N:tile`` shapes of ``--fast-small``) and held against its twin (up to
65,536 bodies) and the f32 kernel. Both symmetric kernels are run twice for
bitwise equality (``repeatable``) and carry their slots' bytes
(``slot_bytes``) and, from a ``torch.profiler`` trace, the device ms of the
pair kernel and of the slots' sum (``by_kernel_ms``, ``sum_share``). Each block case
``NIxNJ`` is the all-pairs kernel's block form: NI rows sampled from a
Plummer sphere of NJ bodies (the treecode error probe's shape) or, with NI a
fourth of NJ or more, its first NI bodies (a ring step's shape). For each
near case (a size suffix as in ``treecode_profile``: ``t`` tuned, ``f``
flat, ``d`` dense) the near kernel is run twice for bitwise equality, and
the largest and the mean number of chunks a target row has are given. Each
VIP case (the panel of W VIP bodies against all N rows), far case (target
rows against the node summaries of their far chunks), single-level far case
(target rows against every level-0 summary their near mask leaves) and
near-panel case (each target tile against its gathered panel) is held
against its plain twin, run twice for bitwise equality, and timed as a
whole call and, from a ``torch.profiler`` trace, kernel by kernel (the VIP
sweep is a pair kernel and a summing kernel); the far cases also give their
live body-node terms and their chunks (or unmasked tiles) a row. Each line
carries the
table's bound (``bound_ms``: operations over the peak rates) and the issue
floor (``issue_floor_ms``: the instruction slots a pair needs over the
multiprocessors' issue rate at the SM clock ``nvidia-smi`` shows during the
run). ``--cap`` times the symmetric f32 and the all-pairs kernel once each at
sizes above ``auto``'s switch, with the peak device memory of each call and
whether two symmetric launches are bitwise equal.

Before the cases, the registers and spills ``ptxas`` reported for the
sources of ``COUNTED`` (the pair and term kernels and the work lists' row
selection), and the instructions a pair of each pair or term kernel's inner
loops counted in the built library's SASS (``cuobjdump -sass``; the listing
is kept beside ``--json``).

``--before ROOT`` names the root of another checkout of this repository
(``mkdir before; git archive <commit> | tar -x -C before``). The inputs of
every case are saved to a file, and a process of its own in each checkout
times that checkout's wrappers on them, by CUDA events, in turns: before,
after, after, before. ``ms`` and ``previous_ms`` are then the means of each
one's two turns, ``device_ms`` and ``previous_device_ms`` the same for the
device time of the kernels alone (a ``torch.profiler`` trace: where the
host enqueues a call more slowly than the card runs it, as the VIP sweep
and the far field below 524,288 bodies, the events time the host), and
``max_abs_vs_before`` the largest difference of the two outputs, and
``differ_a_repeat`` / ``previous_differ_a_repeat`` how many output rows
(elements, for the VIP sweep's pair) two launches in a row of each
checkout's kernel left different (0 for a repeatable kernel). Each checkout
builds its own kernels; only the wrappers' public signatures have to agree.

``--divergence N:S1,S2`` runs, in a process of this checkout (and of
``--before``'s), two ``Simulation(SimConfig(integrator="leapfrog"))`` of a
Plummer sphere of N bodies (seed 0; ``auto``: the symmetric f32 kernel) from
the same state and reports, after S1 and S2 steps, the largest |difference|
of their positions and how many bodies differ: what a kernel whose sums
change order from launch to launch does to a chaotic run.

``--sweep`` also times the near kernel over block sizes, stage sizes and
targets a block, the all-pairs kernel over parts and pieces, the
bf16x3/mixed kernel over its block shapes, the VIP sweep over the splits of
``vip_split``, the far field over those of ``far_split``, the single-level
far field over those of ``single_split`` and the near-panel kernel over
those of ``panel_split``. One JSON object
with every number and the card's name and power limit ends the output (also
written to ``--json``).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

PHYS = dict(eps2=1e-6, compensate=0.1, G=1.0)
# FP32 operations a pair one way and both ways (an FMA two, an rsqrt one), as
# the kernels' bound counts them, and the FP32 peak of an H100 SXM.
PAIR_FLOPS, PAIR_BOTH_FLOPS, PEAK_FLOPS = 20, 27, 67e12
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
# The fast symmetric modes: a pair's FP32 work one way plus the reaction
# weight, and the three bf16 passes of the [x y z 1] panel product on the
# tensor cores (3 passes x 4 components x 2 operations).
FAST_PAIR_FLOPS, FAST_PAIR_TC_FLOPS, PEAK_BF16 = 21, 24, 989e12
# Issue slots a pair: one way 13 FP32 instructions, a MUFU rsqrt and a
# shared load; both ways 17 FP32, the rsqrt and a fourth of a load, three
# shuffles and three adds (four row bodies a thread). A fast-mode pair: the
# 14 of a pair one way, the reaction weight, three for its hi/lo split (a
# pack, two unpacks, two subtractions and a pack for two weights) and one
# for the shared loads, the stores and the three mma.sync of eight pairs.
PAIR_SLOTS, PAIR_BOTH_SLOTS, FAST_PAIR_SLOTS = 15.0, 19.5, 19.0
# A VIP pair is a pair both ways, as in the symmetric kernel: four row bodies
# a thread, the reaction by the same three-shuffle rotation.
VIP_PAIR_SLOTS = PAIR_BOTH_SLOTS
# A body-node term: 33 FP32 instructions with the MUFU rsqrt (3 for d, 3 for
# |d|^2, 1 for c^2 |d|^2 + eps2, the rsqrt, 9 for S d, 3 for d'Sd, 7 for the
# powers of u and the weight with node constants scaled when staged, 6 FMAs
# into the sums; far_term in csrc/nodes.cuh), and the three 16-byte shared
# loads of the node's row. Both far kernels (8/9 and 3) hold two targets a
# thread, so the loads serve two terms.
NODE_TERM_INSTRUCTIONS, NODE_ROW_LOADS = 33, 3
FAR_TERM_SLOTS = NODE_TERM_INSTRUCTIONS + NODE_ROW_LOADS / 2         # 34.5
FAR_SINGLE_TERM_SLOTS = FAR_TERM_SLOTS
# FP32 operations of a body-node term (monopole + quadrupole) as those 33
# instructions do it, an FMA two.
NODE_FLOPS = 52
# A body-node distance of the acceptance build (csrc/min_dist.cu): three
# subtractions, three multiplies and two adds, no FMA; the minimum is a
# ninth issue slot (the shared load of a body serves four nodes, left out).
MIN_DIST_FLOPS, MIN_DIST_SLOTS = 8, 9.0
LANES_A_CLOCK = 128   # FP32 lanes a multiprocessor issues a clock
FAST_TILE = 512
# (threads a block, bodies a stage, most targets a block)
NEAR_SPLITS = ((128, 512, 1024), (256, 512, 1024), (512, 512, 1024), (512, 2048, 1024),
               (1024, 2048, 1024), (1024, 2048, 128), (1024, 2048, 64), (1024, 2048, 32),
               (512, 2048, 64), (512, 2048, 32))
# (most targets a block, parts, chunks a stage) of the far kernel's sweep.
FAR_SPLITS = ((128, 4, 2), (128, 8, 4), (128, 8, 2), (128, 4, 1), (128, 2, 1), (64, 8, 2),
              (64, 16, 4), (32, 16, 2), (32, 32, 4))
# (blocks aimed at, most VIPs a piece) of the VIP sweep's.
VIP_SPLITS = ((2048, 512), (1024, 512), (1024, 4096), (1024, 1024), (1024, 256), (512, 512),
              (4096, 512), (16384, 512))
# (threads aimed at, mask entries a thread a stage) of the single-level far
# field's sweep.
SINGLE_SPLITS = ((256, 2), (256, 1), (128, 2), (128, 1), (512, 2), (512, 1), (64, 2))
# (threads aimed at, panel rows a stage) of the near-panel kernel's sweep.
PANEL_SPLITS = ((256, 1024), (128, 1024), (512, 1024), (256, 512), (256, 2048),
                (128, 2048), (512, 512))
# The kernels whose registers and SASS are printed: source -> kernel name.
# The row selection (top_k.cu) has no pair loop: its registers and spills
# are printed, and its SASS kept beside --json.
COUNTED = {"allpairs.cu": "allpairs_acc_kernel", "symmetric.cu": "symmetric_acc_kernel",
           "symmetric_bf16x3.cu": "symmetric_bf16x3_kernel", "near.cu": "near_field_kernel",
           "vip.cu": "vip_both_kernel", "far_hier.cu": "far_field_kernel",
           "far_single.cu": "far_single_kernel", "near_panel.cu": "near_panel_kernel",
           "top_k.cu": "top_k_kernel"}
# What a process of either checkout runs: argv = cases file, results file.
WORKER = """
import pathlib, sys, torch
from torch.profiler import ProfilerActivity, profile
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode
assert pathlib.Path(cuda_symmetric.__file__).resolve().is_relative_to(pathlib.Path.cwd().resolve())
fns = {"symmetric": cuda_symmetric.symmetric_acc, "near": cuda_treecode.near_field,
       "allpairs": cuda_force.block_acc, "symmetric_bf16x3": cuda_symmetric.symmetric_acc_bf16x3,
       "vip": cuda_treecode.vip_both, "far": cuda_treecode.far_field_hier,
       "far_single": cuda_treecode.far_field_single, "near_panel": cuda_treecode.near_panel}
rows = []
for case in torch.load(sys.argv[1], map_location="cuda", weights_only=False):
    fn = lambda: fns[case["kernel"]](*case["args"], **case["kw"])
    out, again = fn(), fn()
    if isinstance(out, tuple):   # the VIP sweep: action, reaction
        out, again = (torch.cat([o.reshape(-1) for o in x]) for x in (out, again))
    differ = out != again
    differ = int((differ.reshape(differ.shape[0], -1).any(1) if differ.dim() > 1
                  else differ).sum())
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(case["reps"]):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(case["reps"]):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages())
    rows.append({"ms": start.elapsed_time(end) / case["reps"], "out": out.cpu(),
                 "device_ms": device_us / 1e3 / case["reps"], "differ": differ})
torch.save(rows, sys.argv[2])
"""
# What a process of either checkout runs for --divergence: argv = N, steps.
DIVERGE = """
import json, sys, torch
import n_body_problem_tpu_torch as nb
n, marks = int(sys.argv[1]), [int(x) for x in sys.argv[2].split(",")]
sims = [nb.Simulation(nb.SimConfig(integrator="leapfrog"), nb.models.plummer(n, seed=0),
                      device="cuda") for _ in range(2)]
assert sims[0].solver == "pallas_symmetric", sims[0].solver
out, done = {"n": n, "solver": sims[0].solver}, 0
for mark in marks:
    for sim in sims:
        sim.run(mark - done)
    done = mark
    d = (sims[0].state.pos - sims[1].state.pos)[: sims[0].state.n_real]
    out[str(mark)] = {"max_abs_dpos": float(d.abs().max()),
                      "bodies_differ": int((d != 0).any(1).sum())}
print(json.dumps(out))
"""


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` shows now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def issue_floor_ms(pairs: float, slots: float, clock_mhz: float) -> float:
    """The least time the card's multiprocessors need to issue ``slots``
    instructions a pair, one a lane a clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs * slots / (sms * LANES_A_CLOCK * clock_mhz * 1e6) * 1e3


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def fast_pairs(n: int, tile: int, precision: str) -> tuple[int, int]:
    """(near, fast): the pairs of one fast-mode call whose reaction is exact
    f32 (the diagonals s <= near_s) and those whose reaction is the bf16x3
    panel product."""
    from n_body_problem_tpu_torch.ops.cuda_symmetric import near_diagonals

    k = n // tile
    near = sum((k // 2 if k % 2 == 0 and s == k // 2 else k) * (tile * tile if s else
                                                                tile * (tile - 1) // 2)
               for s in range(near_diagonals(k, precision) + 1))
    return near, n * (n - 1) // 2 - near


def fast_bound(n: int, tile: int, precision: str) -> dict:
    """``bound`` of one fast-mode call, counting this call's pairs: the
    diagonals s <= near_s take the f32 reaction (PAIR_BOTH_FLOPS), the
    others FAST_PAIR_FLOPS on the FP32 units and FAST_PAIR_TC_FLOPS on the
    tensor cores at the bf16 peak."""
    near, fast = fast_pairs(n, tile, precision)
    t_tc = FAST_PAIR_TC_FLOPS * fast / PEAK_BF16 * 1e3
    b = bound(PAIR_BOTH_FLOPS * near + FAST_PAIR_FLOPS * fast, n * 16 + n * 12)
    if t_tc > b["bound_ms"]:
        b = {"bound_ms": t_tc, "bound_by": "operations"}
    return b


def fast_issue_floor_ms(n: int, tile: int, precision: str, clock_mhz: float) -> float:
    """The issue floor of one fast-mode call: its f32 diagonals at the f32
    kernel's slots a pair, the others at FAST_PAIR_SLOTS."""
    near, fast = fast_pairs(n, tile, precision)
    return (issue_floor_ms(near, PAIR_BOTH_SLOTS, clock_mhz)
            + issue_floor_ms(fast, FAST_PAIR_SLOTS, clock_mhz))


def near_work(args, kw) -> dict:
    """What a near-kernel call has to do: ``pairs``, its live entries
    (sentinels and the unused tail left out) times the source tile times the
    target row; and the largest and the mean number of chunks a target row
    has (their ratio bounds what a schedule of whole rows can reach)."""
    _, _, flat_src, chunk_tgt = args
    e = kw["entries"]
    k_t = kw["n"] // kw["tile"]
    ids = flat_src[:chunk_tgt.shape[0] * e].reshape(-1, e)
    live = (ids != kw["n_s"] // kw["src_tile"]) & (chunk_tgt < k_t)[:, None]
    per_row = torch.bincount(chunk_tgt[chunk_tgt < k_t].long(), minlength=k_t)
    return {"pairs": int(live.sum()) * kw["src_tile"] * kw["tile"],
            "chunks_max": int(per_row.max()), "chunks_mean": float(per_row.float().mean())}


def vip_work(args, kw) -> dict:
    """What a VIP sweep has to do: every row against every panel body, both
    ways."""
    rows, panel = args
    return {"pairs": rows.shape[0] * panel.shape[0], "rows": rows.shape[0],
            "vips": panel.shape[0]}


def far_work(args, kw) -> dict:
    """What a far-field call has to do: ``terms``, the live entries of its
    live chunks (the zero sentinel node, the last summary row, and the unused
    tail left out) times the target row; and the largest and the mean number
    of far chunks a target row has."""
    from n_body_problem_tpu_torch.ops.cuda_treecode import FAR_ENTRIES

    _, summ, far_src, far_tgt = args
    k_t = kw["n"] // kw["tile"]
    ids = far_src[:far_tgt.shape[0] * FAR_ENTRIES].reshape(-1, FAR_ENTRIES)
    live = (ids != summ.shape[0] - 1) & (far_tgt < k_t)[:, None]
    per_row = torch.bincount(far_tgt[far_tgt < k_t].long(), minlength=k_t)
    return {"terms": int(live.sum()) * kw["tile"], "chunks_max": int(per_row.max()),
            "chunks_mean": float(per_row.float().mean())}


def single_work(args, kw) -> dict:
    """What a single-level far call has to do: ``terms``, the source tiles
    that the near mask leaves to the far field (masked tiles left out)
    times the target row; and the largest and the mean number of such tiles
    a target row has."""
    _, _, mask = args
    live = (~mask.bool()).sum(1)
    return {"terms": int(live.sum()) * kw["tile"], "live_max": int(live.max()),
            "live_mean": float(live.float().mean())}


def panel_work(args, kw) -> dict:
    """What a near-panel call has to do: each of the K T targets against
    every one of the W rows of its tile's panel, K x T x W pairs."""
    _, panels = args
    k, w = panels.shape[:2]
    return {"pairs": k * kw["tile"] * w, "tiles": k, "width": w}


# Per treecode kernel: its work function, the key of the count it returns,
# and the issue slots one such interaction takes.
TREE_WORK = {"vip": (vip_work, "pairs", VIP_PAIR_SLOTS), "far": (far_work, "terms", FAR_TERM_SLOTS),
             "far_single": (single_work, "terms", FAR_SINGLE_TERM_SLOTS),
             "near_panel": (panel_work, "pairs", PAIR_SLOTS)}


def tree_bound(key: str, args, kw) -> dict:
    """``bound`` of a VIP, far, single-level far or near-panel call on these
    inputs: the work of ``TREE_WORK`` over the FP32 peak, or each input read
    and each output written once over the memory rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    if key == "vip":
        rows, panel = args
        return bound(PAIR_BOTH_FLOPS * vip_work(args, kw)["pairs"],
                     nbytes + (rows.shape[0] + panel.shape[0]) * 12)
    if key == "near_panel":
        work = panel_work(args, kw)
        return bound(PAIR_FLOPS * work["pairs"], nbytes + work["tiles"] * kw["tile"] * 12)
    work = (far_work if key == "far" else single_work)(args, kw)
    return bound(NODE_FLOPS * work["terms"], nbytes + kw["n"] * 12)


# ------------------------------------------------------------------- SASS
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRANCH = re.compile(r"\bBRA\b[^;]*?0x([0-9a-f]+)")


def sass_functions(listing: str) -> dict:
    """``cuobjdump -sass`` output cut into {function name: [(address,
    instruction text)]}."""
    fns, cur = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            cur = fns.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _SASS_LINE.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return fns


def _opcode(text: str) -> str:
    words = [w for w in text.replace("{", " ").split() if not w.startswith("@")]
    return words[0] if words else "?"


def sass_pair_loops(instrs: list) -> list[dict]:
    """The innermost loops of one function that evaluate pairs (a backward
    branch with no other backward branch inside and at least one
    ``MUFU.RSQ``): instructions, rsqrts (one a pair), instructions a pair and
    the count of each opcode family."""
    loops = []
    for addr, text in instrs:
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    out = []
    for lo, hi in loops:
        if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in loops):
            continue
        body = [_opcode(t) for a, t in instrs if lo <= a <= hi]
        pairs = sum(op.startswith("MUFU.RSQ") for op in body)
        if not pairs:
            continue
        fam = collections.Counter(op.split(".")[0] for op in body)
        out.append({"instructions": len(body), "pairs": pairs,
                    "a_pair": len(body) / pairs, "by_opcode": dict(fam.most_common())})
    return sorted(out, key=lambda d: -d["pairs"])


def sass_report(lib: pathlib.Path, keep: pathlib.Path | None) -> dict:
    """Instructions a pair of the inner loops of each kernel of ``COUNTED``
    in the built library ``lib``; the listing of those kernels goes to
    ``keep``. Empty without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).is_file():
        print("  sass| no cuobjdump: instructions a pair not counted")
        return {}
    listing = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             check=True).stdout
    report = {}
    kept = []
    for name, instrs in sass_functions(listing).items():
        kernel = next((k for k in COUNTED.values() if k in name), None)
        if kernel is None:
            continue
        kept.append(f"Function : {name}\n" + "\n".join(f"/*{a:04x}*/ {t} ;" for a, t in instrs))
        for loop in sass_pair_loops(instrs):
            report.setdefault(kernel, []).append(loop)
            print(f"  sass| {kernel}: loop of {loop['instructions']} instructions, "
                  f"{loop['pairs']} pairs, {loop['a_pair']:.2f} a pair: {loop['by_opcode']}")
    if keep is not None:
        keep.parent.mkdir(parents=True, exist_ok=True)
        keep.write_text("\n\n".join(kept))
    return report


# ------------------------------------------------------------------ cases
def plummer(n: int):
    from n_body_problem_tpu_torch import models

    return models.plummer(n, seed=n).to("cuda")


def _reps(pairs: float) -> int:
    return 10 if pairs <= 65536 ** 2 else 3


def symmetric_case(n: int) -> dict:
    s = plummer(n)
    return {"kernel": "symmetric", "label": str(n), "args": [s.pos, s.mass],
            "kw": dict(PHYS), "reps": _reps(n * n)}


def allpairs_case(ni: int, nj: int) -> dict:
    """The all-pairs kernel's block form: ``ni`` rows against the ``nj``
    bodies of a Plummer sphere. ``ni == nj``: the sphere against itself.
    Fewer than a fourth: rows sampled at random as the treecode error probe
    samples them; else the first ``ni`` bodies, one device's share of a ring."""
    s = plummer(nj)
    if ni == nj:
        rows = s.pos
    elif 4 * ni < nj:
        gen = torch.Generator(device="cpu").manual_seed(0)
        rows = s.pos[torch.randperm(nj, generator=gen)[:ni].sort().values.to("cuda")]
    else:
        rows = s.pos[:ni].clone()
    return {"kernel": "allpairs", "label": f"{ni}x{nj}", "args": [rows, s.pos, s.mass],
            "kw": dict(tile_i=256, tile_j=256, **PHYS), "reps": _reps(ni * nj)}


def fast_case(n: int, precision: str, tile: int = FAST_TILE) -> dict:
    s = plummer(n)
    return {"kernel": "symmetric_bf16x3", "label": f"{n}:{tile} {precision}",
            "args": [s.pos, s.mass], "kw": dict(tile=tile, precision=precision, **PHYS),
            "reps": _reps(n * n)}


def near_golden_case(device) -> tuple[tuple, dict]:
    """``(args, kw)`` of one device's near-kernel call on fixed inputs made
    with numpy from a seed (65,536 bodies, rows of 128, 32 entries of 64
    bodies a chunk, 1-4 chunks a row, a tenth of the entries the sentinel, a
    sentinel tail): the call whose output digest :data:`NEAR_GOLDEN_SHA256`
    records, so that a change to the kernel can be held to its earlier
    output bit for bit."""
    n, tile, src_tile, entries = 65536, 128, 64, 32
    k_t, k_s = n // tile, n // src_tile
    rng = np.random.default_rng(11)
    bodies = np.zeros((n + src_tile, 4), np.float32)
    bodies[:n, :3] = rng.standard_normal((n, 3), np.float32)
    bodies[:n, 3] = rng.uniform(0.5, 1.5, n).astype(np.float32) * np.float32(1e-3 / n)
    chunk_tgt = np.concatenate([np.repeat(np.arange(k_t), rng.integers(1, 5, k_t)),
                                np.full(16, k_t)]).astype(np.int32)
    flat_src = rng.integers(0, k_s, chunk_tgt.shape[0] * entries).astype(np.int32)
    flat_src[rng.random(flat_src.shape[0]) < 0.1] = k_s
    b = torch.from_numpy(bodies).to(device)
    return ((b, b, torch.from_numpy(flat_src).to(device), torch.from_numpy(chunk_tgt).to(device)),
            dict(n=n, n_s=n, tile=tile, src_tile=src_tile, entries=entries, eps2=1e-6, c2=0.01))


# sha256 of ``near_field(*near_golden_case(cuda))``'s output bytes, from the
# kernel before it took targets and sources apart (one ``bodies`` array; an
# NVIDIA H100 80GB HBM3 at 700.00 W), which the split must leave bit for bit.
NEAR_GOLDEN_SHA256 = "cc95763ebe3915d38d233c8c458181c77b75bdc9d953e842250904605a905bf0"


def tree_case(kernel: str, tok: str) -> dict:
    """The ``kernel``'s (near, vip or far) inputs at the size token ``tok``
    (as ``treecode_profile``'s ``--sizes``) on the path that size takes."""
    from n_body_problem_tpu_torch.treecode_profile import _size, kernel_inputs

    n, overrides = _size(tok)
    args, kw = kernel_inputs(n, torch.device("cuda", 0), **overrides)["kernels"][kernel]
    return {"kernel": kernel, "label": tok, "args": list(args), "kw": kw, "reps": 10}


def allpairs_sweep(ni: int, nj: int) -> list[tuple[int, int, int]]:
    """``(rows, parts, pieces)`` the all-pairs kernel takes for this shape
    besides ``cuda_force.allpairs_split``'s: every ``parts`` with one piece
    and with the piece counts that bring the grid to one, four and eight
    times ``ALLPAIRS_MIN_BLOCKS``."""
    from n_body_problem_tpu_torch.ops import cuda_force as cf

    stages = max(1, -(-nj // cf.ALLPAIRS_STAGE))
    out = []
    for parts in cf.ALLPAIRS_PARTS:
        rows = cf.ALLPAIRS_BLOCK_ROWS // parts
        row_blocks = max(1, -(-ni // rows))
        for mult in (0, 1, 4, 8):
            want = max(1, min(stages, -(-mult * cf.ALLPAIRS_MIN_BLOCKS // row_blocks)))
            split = (rows, parts, -(-stages // -(-stages // want)))
            if split not in out:
                out.append(split)
    return out


def _rel(got, want):
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)


def symmetric_row(case: dict) -> dict:
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    pos, mass = case["args"]
    n = pos.shape[0]
    allpairs = lambda: cuda_force.block_acc(pos, pos, mass, tile_i=256, tile_j=256, **PHYS)  # noqa: E731
    kernel = lambda: cuda_symmetric.symmetric_acc(pos, mass, **PHYS)  # noqa: E731
    want, got = allpairs(), kernel()
    torch.cuda.synchronize()
    pairs = n * (n - 1) / 2
    repeatable = bool(torch.equal(got, kernel()))
    allpairs_ms, ms = time_ms(allpairs, case["reps"]), time_ms(kernel, case["reps"])
    clock = sm_clock_mhz()   # just after the load
    n_pad = -(-n // cuda_symmetric.KERNEL_TILE) * cuda_symmetric.KERNEL_TILE
    return {"n": n, "allpairs_ms": allpairs_ms, "ms": ms,
            "max_rel_vs_allpairs": float(_rel(got, want).max()),
            "momentum": float((mass[:, None] * got).sum(0).abs().max()),
            "repeatable": repeatable, **slot_record(
                kernel, case["reps"], cuda_symmetric.slot_bytes(n_pad, cuda_symmetric.KERNEL_TILE)),
            "clock_mhz": clock, "bound_ms": PAIR_BOTH_FLOPS * pairs / PEAK_FLOPS * 1e3,
            "issue_floor_ms": issue_floor_ms(pairs, PAIR_BOTH_SLOTS, clock)}


def slot_record(kernel, reps: int, slot_bytes: int) -> dict:
    """A symmetric kernel's slots: their bytes, the least time the card
    needs to write and read them once, and the device ms of each kernel of
    a call (the pair kernel, the slots' sum) from the profiler, with the
    sum's share of the two."""
    by = kernel_ms(kernel, reps)
    return {"by_kernel_ms": by,
            "sum_share": by.get("symmetric_sum_kernel", 0.0) / sum(by.values()),
            "slot_bytes": slot_bytes, "slot_bytes_ms": 2 * slot_bytes / PEAK_BYTES * 1e3}


def allpairs_row(case: dict, sweep: bool) -> dict:
    """The all-pairs kernel at one (rows, columns) shape: held against its
    twin (up to 2^32 pairs), run twice for bitwise equality, timed."""
    from n_body_problem_tpu_torch.ops import cuda_force as cf
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    rows, pos, mass = case["args"]
    ni, nj = rows.shape[0], pos.shape[0]
    kernel = lambda: cf.block_acc(rows, pos, mass, **case["kw"])  # noqa: E731
    before = cf.block_acc.launches
    got = kernel()
    launches = cf.block_acc.launches - before
    torch.cuda.synchronize()
    row = {"case": case["label"], "ni": ni, "nj": nj, "launches_a_call": launches,
           "repeatable": bool(torch.equal(got, kernel()))}
    split = getattr(cf, "allpairs_split", None)
    if split is not None:
        row["split"] = split(ni, nj)
    if ni * nj <= 1 << 32:
        want = cf.block_acc_plain(rows, pos, mass, **PHYS)
        row["max_abs_err"] = float((got - want).abs().max())
        row["allclose_plain"] = bool(torch.allclose(got, want, rtol=1e-4, atol=2e-6))
        del want
    row["ms"] = time_ms(kernel, case["reps"])
    clock = sm_clock_mhz()
    row.update(clock_mhz=clock, issue_floor_ms=issue_floor_ms(ni * nj, PAIR_SLOTS, clock),
               **bound(PAIR_FLOPS * ni * nj, (ni * 3 + nj * 4 + ni * 3) * 4))
    if sweep and split is not None:
        row["by_rows_parts_pieces"] = {}
        for other in allpairs_sweep(ni, nj):
            cf.allpairs_split = lambda *_, other=other: other
            ok = torch.allclose(kernel(), got, rtol=1e-4, atol=2e-6)
            row["by_rows_parts_pieces"]["x".join(map(str, other))] = (
                time_ms(kernel, case["reps"]) if ok else float("nan"))
        cf.allpairs_split = split
    return row


def fast_row(case: dict, sweep: bool) -> dict:
    """The bf16x3/mixed kernel at one size: timed beside the f32 kernel,
    held against its twin by the distance ratio (up to 65,536 bodies) and
    against the f32 kernel by the per-body p99."""
    from n_body_problem_tpu_torch.ops import cuda_symmetric as cs
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    pos, mass = case["args"]
    kw = case["kw"]
    n, tile, prec = pos.shape[0], kw["tile"], kw["precision"]
    kernel = lambda: cs.symmetric_acc_bf16x3(pos, mass, **kw)  # noqa: E731
    f32 = cs.symmetric_acc(pos, mass, tile=tile, **PHYS)
    got = kernel()
    torch.cuda.synchronize()
    row = {"case": case["label"], "n": n, "tile": tile, "precision": prec,
           "p99_vs_f32": float(torch.quantile(_rel(got, f32)[:: max(1, n // 65536)], 0.99)),
           "repeatable": bool(torch.equal(got, kernel()))}
    if n <= 65536:
        twin = cs.symmetric_acc_plain(pos, mass, **kw)
        f32_twin = cs.symmetric_acc_plain(pos, mass, tile=tile, **PHYS)
        if (twin - f32_twin).any():   # "mixed" with K <= 3 tiles is the f32 mode
            row["ratio_vs_twin"] = float((got - twin).norm() / (twin - f32_twin).norm())
        row["p99_vs_twin"] = float(torch.quantile(_rel(got, twin), 0.99))
        del twin, f32_twin
    row["ms"] = time_ms(kernel, case["reps"])
    row["f32_ms"] = time_ms(lambda: cs.symmetric_acc(pos, mass, tile=tile, **PHYS),
                            case["reps"])
    row.update(slot_record(kernel, case["reps"], cs.slot_bytes(n, tile)))
    clock = sm_clock_mhz()
    row.update(clock_mhz=clock, issue_floor_ms=fast_issue_floor_ms(n, tile, prec, clock),
               **fast_bound(n, tile, prec))
    shapes = getattr(cs, "FAST_SHAPES", None)
    if sweep and shapes is not None:
        keep = cs.FAST_SHAPE
        row["by_shape"] = {}
        for shape in shapes:
            cs.FAST_SHAPE = shape
            ok = float(torch.quantile(_rel(kernel(), got), 0.99)) < 1.5e-5
            row["by_shape"]["x".join(map(str, shape))] = (
                time_ms(kernel, case["reps"]) if ok else float("nan"))
        cs.FAST_SHAPE = keep
    return row


def _flat(out) -> torch.Tensor:
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


def device_ms(fn, reps: int) -> float:
    """Device ms of a call of ``fn``, all its kernels (``kernel_ms``)."""
    return sum(kernel_ms(fn, reps).values())


def sweep_constants(kernel, got, reps: int, names: tuple[str, ...], settings,
                    timer=None) -> dict:
    """``kernel``'s time (``timer``, by default ``time_ms``) with each setting
    of the ``cuda_treecode`` constants ``names`` (NaN where its output leaves
    rtol 1e-4, atol 2e-6 of ``got``); the constants are restored after."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    timer = timer or time_ms
    keep = tuple(getattr(ct, k) for k in names)
    out = {}
    try:
        for values in settings:
            for k, v in zip(names, values):
                setattr(ct, k, v)
            ok = torch.allclose(_flat(kernel()), _flat(got), rtol=1e-4, atol=2e-6)
            out["x".join(map(str, values))] = timer(kernel, reps) if ok else float("nan")
    finally:
        for k, v in zip(names, keep):
            setattr(ct, k, v)
    return out


def _kernel_name(name: str) -> str:
    m = re.search(r"([A-Za-z_]\w*)\s*(?:<[^()]*>)?\s*\(",
                  name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of ``fn`` spends in each kernel it launches, by name,
    from a ``torch.profiler`` trace of ``reps`` calls."""
    from n_body_problem_tpu_torch.treecode_profile import _trace

    fn()
    torch.cuda.synchronize()
    events, _ = _trace(lambda: [fn() for _ in range(reps)])
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = _kernel_name(e["name"])
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / reps
    return out


def near_row(case: dict, sweep: bool) -> dict:
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    args, kw = case["args"], case["kw"]
    kernel = lambda: ct.near_field(*args, **kw)  # noqa: E731
    got = kernel()
    torch.cuda.synchronize()
    work = near_work(args, kw)
    ms = time_ms(kernel, case["reps"])
    clock = sm_clock_mhz()   # just after the load
    row = {"case": case["label"], "n": kw["n"], "tile": kw["tile"], "src_tile": kw["src_tile"],
           "entries": kw["entries"],
           "split": ct.near_split(kw["tile"], kw["entries"], kw["src_tile"]),
           "chunks_max": work["chunks_max"], "chunks_mean": work["chunks_mean"],
           "ms": ms, "repeatable": bool(torch.equal(got, kernel())),
           "clock_mhz": clock, "bound_ms": PAIR_FLOPS * work["pairs"] / PEAK_FLOPS * 1e3,
           "issue_floor_ms": issue_floor_ms(work["pairs"], PAIR_SLOTS, clock)}
    if sweep:
        row["by_block_piece_targets"] = sweep_constants(
            kernel, got, case["reps"], ("NEAR_BLOCK", "NEAR_PIECE_BODIES", "NEAR_TARGETS"),
            NEAR_SPLITS)
    return row


def tree_row(case: dict, sweep: bool) -> dict:
    """The VIP sweep, the far field, the single-level far field or the
    near-panel kernel at one size: held against its twin, run twice for
    bitwise equality, timed as a call and kernel by kernel, beside its bound
    and issue floor."""
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    key, args, kw = case["kernel"], case["args"], case["kw"]
    fn, plain = {"vip": (ct.vip_both, ct.vip_both_plain),
                 "far": (ct.far_field_hier, ct.far_field_hier_plain),
                 "far_single": (ct.far_field_single, ct.far_field_single_plain),
                 "near_panel": (ct.near_panel, ct.near_panel_plain)}[key]
    kernel = lambda: fn(*args, **kw)  # noqa: E731
    before = fn.launches
    got = kernel()
    launches = fn.launches - before
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    row = {"case": case["label"], "launches_a_call": launches,
           "repeatable": bool(torch.equal(_flat(got), _flat(kernel()))),
           "max_abs_err": float((_flat(got) - _flat(want)).abs().max()),
           "allclose_plain": bool(torch.allclose(_flat(got), _flat(want), rtol=1e-4,
                                                 atol=2e-6))}
    del want
    work_fn, count_key, slots = TREE_WORK[key]
    work = work_fn(args, kw)
    if key == "vip":
        row["split"] = ct.vip_split(work["rows"], work["vips"])
    else:
        split = {"far": ct.far_split, "far_single": ct.single_split,
                 "near_panel": ct.panel_split}[key]
        row.update(tile=kw["tile"], split=split(kw["tile"]))
    if key == "far":
        row.update(n=kw["n"], chunks=args[3].shape[0], summ_rows=args[1].shape[0])
    elif key == "far_single":
        row.update(n=kw["n"], k_s=args[2].shape[1])
    row["ms"] = time_ms(kernel, case["reps"])
    clock = sm_clock_mhz()   # just after the load
    row["by_kernel_ms"] = kernel_ms(kernel, case["reps"])
    row["device_ms"] = sum(row["by_kernel_ms"].values())
    count = work.pop(count_key)
    row.update(work, clock_mhz=clock, issue_floor_ms=issue_floor_ms(count, slots, clock),
               **{count_key: count}, **tree_bound(key, args, kw))
    if sweep:
        row["sweep_device_ms"] = sweep_constants(kernel, got, case["reps"], *tree_sweep(key),
                                                 timer=device_ms)
    return row


def tree_sweep(key: str) -> tuple[tuple[str, ...], list]:
    """The ``cuda_treecode`` constants behind ``vip_split``, ``far_split``,
    ``single_split`` and ``panel_split``, and the settings ``--sweep``
    times."""
    return {"vip": (("VIP_BLOCKS", "VIP_MAX_PIECE"), VIP_SPLITS),
            "far": (("FAR_TARGETS", "FAR_PARTS", "FAR_STAGE_CHUNKS"), FAR_SPLITS),
            "far_single": (("SINGLE_THREADS", "SINGLE_ENTRIES"), SINGLE_SPLITS),
            "near_panel": (("PANEL_THREADS", "PANEL_STAGE"), PANEL_SPLITS)}[key]


def cap_row(n: int) -> dict:
    """The symmetric f32 and the all-pairs kernel once each at ``n`` bodies
    (above ``auto``'s switch), with the peak device memory of each call
    beyond what was allocated before it, the symmetric kernel's slot bytes,
    and whether its launches repeat bitwise."""
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    s = plummer(n)
    fns = {"symmetric": lambda: cuda_symmetric.symmetric_acc(s.pos, s.mass, **PHYS),
           "allpairs": lambda: cuda_force.block_acc(s.pos, s.pos, s.mass, tile_i=256,
                                                    tile_j=256, **PHYS)}
    row = {"n": n}
    outs = {}
    for key, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        row[f"{key}_ms"] = time_ms(fn, 1)
        row[f"{key}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        outs[key] = fn()
        if key == "symmetric":
            row["symmetric_repeatable"] = bool(torch.equal(outs[key], fn()))
            row["symmetric_slot_bytes"] = cuda_symmetric.slot_bytes(
                n, cuda_symmetric.KERNEL_TILE)
    row["max_rel_between"] = float(_rel(outs["symmetric"], outs["allpairs"]).max())
    return row


def divergence(root: pathlib.Path, n: int, steps: str) -> dict:
    """``DIVERGE`` in a process of the checkout at ``root``."""
    out = subprocess.run([sys.executable, "-c", DIVERGE, str(n), steps], cwd=root,
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def in_turns(cases: list[dict], rows: list[dict], before: pathlib.Path) -> None:
    """Time every case in a process of the checkout ``before`` and of this
    one, before, after, after, before, and put the means into ``rows``."""
    here = pathlib.Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory() as tmp:
        saved = pathlib.Path(tmp) / "cases.pt"
        torch.save([{k: c[k] for k in ("kernel", "args", "kw", "reps")} for c in cases], saved)
        turns = []
        for i, root in enumerate((before, here, here, before)):
            out = pathlib.Path(tmp) / f"turn{i}.pt"
            subprocess.run([sys.executable, "-c", WORKER, str(saved), str(out)],
                           cwd=root, check=True)
            turns.append(torch.load(out, weights_only=False))
    for j, row in enumerate(rows):
        b1, a1, a2, b2 = (t[j] for t in turns)
        row["ms"] = (a1["ms"] + a2["ms"]) / 2
        row["previous_ms"] = (b1["ms"] + b2["ms"]) / 2
        row["turns_ms"] = [b1["ms"], a1["ms"], a2["ms"], b2["ms"]]
        row["device_ms"] = (a1["device_ms"] + a2["device_ms"]) / 2
        row["previous_device_ms"] = (b1["device_ms"] + b2["device_ms"]) / 2
        row["turns_device_ms"] = [b1["device_ms"], a1["device_ms"], a2["device_ms"],
                                  b2["device_ms"]]
        row["max_abs_vs_before"] = float((a1["out"] - b1["out"]).abs().max())
        row["differ_a_repeat"] = [a1["differ"], a2["differ"]]
        row["previous_differ_a_repeat"] = [b1["differ"], b2["differ"]]
        row["allclose_before"] = bool(torch.allclose(a1["out"], b1["out"], rtol=1e-4, atol=2e-6))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=pathlib.Path, default=None,
                    help="the root of another checkout to time beside this one")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sizes", default="8192,32768,65536,262144")
    ap.add_argument("--blocks", default="2048x524288,16384x65536")
    ap.add_argument("--fast-small", default="512:64,448:64,1024:512")
    ap.add_argument("--near", default="65536,524288,20480f,65536f,20480t")
    ap.add_argument("--vip", default="65536,524288,20480t")
    ap.add_argument("--far", default="65536,524288,20480t")
    ap.add_argument("--far-single", default="65536f,20480d,2560f")
    ap.add_argument("--near-panel", default="20480d,1024d")
    ap.add_argument("--cap", default="")
    ap.add_argument("--divergence", default="",
                    help="N:S1,S2 - two leapfrog runs of auto from one state, in each checkout")
    ap.add_argument("--json", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: needs a CUDA GPU")
    from n_body_problem_tpu_torch.ops import cuda_build

    cuda_build.load_library()
    log = (cuda_build.library_path().parent / "build.log").read_text()
    for job in log.split("$ ")[1:]:   # one nvcc command and its output each
        if job.splitlines()[0].endswith(tuple(f"/{src}" for src in COUNTED)):
            for line in job.splitlines()[1:]:
                if any(w in line for w in ("registers", "spill", "Compiling entry")):
                    print(f"  ptxas| {line.strip()}")
    sass = sass_report(cuda_build.library_path(),
                       args.json.with_suffix(".sass") if args.json else None)
    sizes = [int(x) for x in filter(None, args.sizes.split(","))]
    cases, rows = [], []

    def add(case, row):
        cases.append(case)
        rows.append(row)
        print(f"{case['kernel']} " + json.dumps(row), flush=True)

    for n in sizes:
        case = symmetric_case(n)
        add(case, symmetric_row(case))
    for ni, nj in [(n, n) for n in sizes] + [tuple(map(int, b.split("x")))
                                             for b in filter(None, args.blocks.split(","))]:
        case = allpairs_case(ni, nj)
        add(case, allpairs_row(case, args.sweep))
    small = [tuple(map(int, x.split(":"))) for x in filter(None, args.fast_small.split(","))]
    for n, tile in small + [(n, FAST_TILE) for n in sizes]:
        for precision in ("bf16x3", "mixed"):
            case = fast_case(n, precision, tile)
            add(case, fast_row(case, args.sweep))
    for tok in filter(None, args.near.split(",")):
        case = tree_case("near", tok)
        add(case, near_row(case, args.sweep))
    for key in ("vip", "far", "far_single", "near_panel"):
        for tok in filter(None, getattr(args, key).split(",")):
            case = tree_case(key, tok)
            add(case, tree_row(case, args.sweep))
            torch.cuda.empty_cache()
    if args.before:
        in_turns(cases, rows, args.before.resolve())
    record = {"symmetric": [], "allpairs": [], "symmetric_bf16x3": [], "near": [], "vip": [],
              "far": [], "far_single": [], "near_panel": []}
    for case, row in zip(cases, rows):
        record[case["kernel"]].append(row)
        if args.before:
            print(f"{case['kernel']} {case['label']}: ms {row['ms']:.4f} previous_ms "
                  f"{row['previous_ms']:.4f} turns {row['turns_ms']} device_ms "
                  f"{row['device_ms']:.4f} previous_device_ms {row['previous_device_ms']:.4f} "
                  f"turns {row['turns_device_ms']} max |d| {row['max_abs_vs_before']:.3e} "
                  f"differ a repeat {row['differ_a_repeat']} previous "
                  f"{row['previous_differ_a_repeat']}", flush=True)
    del cases
    torch.cuda.empty_cache()
    record["cap"] = [cap_row(int(n)) for n in filter(None, args.cap.split(","))]
    for row in record["cap"]:
        print("cap " + json.dumps(row), flush=True)
    if args.divergence:
        n, steps = args.divergence.split(":")
        here = pathlib.Path(__file__).resolve().parent.parent
        record["divergence"] = {"this": divergence(here, int(n), steps)}
        if args.before:
            record["divergence"]["before"] = divergence(args.before.resolve(), int(n), steps)
        print("divergence " + json.dumps(record["divergence"]), flush=True)
    record["sass"] = sass
    record["device"] = torch.cuda.get_device_name(0)
    record["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
