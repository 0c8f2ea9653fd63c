"""The symmetric f32 kernel and the treecode near kernel, timed on one GPU at
the main paths' shapes, beside another checkout's versions of them.

    python -m n_body_problem_tpu_torch.kernel_compare [--before ROOT] [--sweep]
        [--sizes 8192,32768,65536,262144] [--near 65536,524288,20480f,65536f,20480t]
        [--json PATH]

For each size the symmetric kernel is timed beside the all-pairs kernel and
held against it; for each near case (a size suffix as in
``treecode_profile``: ``t`` tuned, ``f`` flat) the near kernel is run twice
for bitwise equality, and the largest and the mean number of chunks a target
row has are given. Each line carries the table's bound (``bound_ms``:
operations over the FP32 peak) and the issue floor (``issue_floor_ms``: the
instruction slots a pair needs over the multiprocessors' issue rate at the
SM clock ``nvidia-smi`` shows during the run).

``--before ROOT`` names the root of another checkout of this repository
(``mkdir before; git archive <commit> | tar -x -C before``). The inputs of
every case are saved to a file, and a process of its own in each checkout
times that checkout's ``symmetric_acc`` and ``near_field`` on them, by CUDA
events, in turns: before, after, after, before. ``ms`` and ``previous_ms``
are then the means of each one's two turns, and ``max_abs_vs_before`` the
largest difference of the two outputs. Each checkout builds its own kernels;
only the wrappers' public signatures have to agree.

``--sweep`` also times the near kernel over block sizes, stage sizes and
targets a block. One JSON object with every number and the card's name and
power limit ends the output (also written to ``--json``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

PHYS = dict(eps2=1e-6, compensate=0.1, G=1.0)
# FP32 operations a pair one way and both ways (an FMA two, an rsqrt one), as
# the kernels' bound counts them, and the FP32 peak of an H100 SXM.
PAIR_FLOPS, PAIR_BOTH_FLOPS, PEAK_FLOPS = 20, 27, 67e12
# Issue slots a pair: one way 13 FP32 instructions, a MUFU rsqrt and a
# shared load; both ways 17 FP32, the rsqrt and a fourth of a load, three
# shuffles and three adds (four row bodies a thread).
PAIR_SLOTS, PAIR_BOTH_SLOTS = 15.0, 19.5
LANES_A_CLOCK = 128   # FP32 lanes a multiprocessor issues a clock
# (threads a block, bodies a stage, most targets a block)
NEAR_SPLITS = ((128, 512, 1024), (256, 512, 1024), (512, 512, 1024), (512, 2048, 1024),
               (1024, 2048, 1024), (1024, 2048, 128), (1024, 2048, 64), (1024, 2048, 32),
               (512, 2048, 64), (512, 2048, 32))
# What a process of either checkout runs: argv = cases file, results file.
WORKER = """
import pathlib, sys, torch
from n_body_problem_tpu_torch.ops import cuda_symmetric, cuda_treecode
assert pathlib.Path(cuda_symmetric.__file__).resolve().is_relative_to(pathlib.Path.cwd().resolve())
fns = {"symmetric": cuda_symmetric.symmetric_acc, "near": cuda_treecode.near_field}
rows = []
for case in torch.load(sys.argv[1], map_location="cuda", weights_only=False):
    fn = lambda: fns[case["kernel"]](*case["args"], **case["kw"])
    out = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(case["reps"]):
        fn()
    end.record()
    torch.cuda.synchronize()
    rows.append({"ms": start.elapsed_time(end) / case["reps"], "out": out.cpu()})
torch.save(rows, sys.argv[2])
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


def near_work(args, kw) -> dict:
    """What a near-kernel call has to do: ``pairs``, its live entries
    (sentinels and the unused tail left out) times the source tile times the
    target row; and the largest and the mean number of chunks a target row
    has (their ratio bounds what a schedule of whole rows can reach)."""
    _, flat_src, chunk_tgt = args
    n, e = kw["n"], kw["entries"]
    k_t = n // kw["tile"]
    ids = flat_src[:chunk_tgt.shape[0] * e].reshape(-1, e)
    live = (ids != n // kw["src_tile"]) & (chunk_tgt < k_t)[:, None]
    per_row = torch.bincount(chunk_tgt[chunk_tgt < k_t].long(), minlength=k_t)
    return {"pairs": int(live.sum()) * kw["src_tile"] * kw["tile"],
            "chunks_max": int(per_row.max()), "chunks_mean": float(per_row.float().mean())}


def symmetric_case(n: int) -> dict:
    from n_body_problem_tpu_torch import models

    s = models.plummer(n, seed=n).to("cuda")
    return {"kernel": "symmetric", "label": str(n), "args": [s.pos, s.mass],
            "kw": dict(PHYS), "reps": 10 if n <= 65536 else 3}


def near_case(tok: str) -> dict:
    from n_body_problem_tpu_torch.treecode_profile import _size, kernel_inputs

    n, overrides = _size(tok)
    args, kw = kernel_inputs(n, torch.device("cuda", 0), **overrides)["kernels"]["near"]
    return {"kernel": "near", "label": tok, "args": list(args), "kw": kw, "reps": 10}


def symmetric_row(case: dict) -> dict:
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
    from n_body_problem_tpu_torch.treecode_profile import time_ms

    pos, mass = case["args"]
    n = pos.shape[0]
    allpairs = lambda: cuda_force.block_acc(pos, pos, mass, tile_i=256, tile_j=256, **PHYS)  # noqa: E731
    kernel = lambda: cuda_symmetric.symmetric_acc(pos, mass, **PHYS)  # noqa: E731
    want, got = allpairs(), kernel()
    torch.cuda.synchronize()
    rel = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)
    pairs = n * (n - 1) / 2
    allpairs_ms, ms = time_ms(allpairs, case["reps"]), time_ms(kernel, case["reps"])
    clock = sm_clock_mhz()   # just after the load
    return {"n": n, "allpairs_ms": allpairs_ms, "ms": ms,
            "max_rel_vs_allpairs": float(rel.max()),
            "momentum": float((mass[:, None] * got).sum(0).abs().max()),
            "clock_mhz": clock, "bound_ms": PAIR_BOTH_FLOPS * pairs / PEAK_FLOPS * 1e3,
            "issue_floor_ms": issue_floor_ms(pairs, PAIR_BOTH_SLOTS, clock)}


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
        keep = ct.NEAR_BLOCK, ct.NEAR_PIECE_BODIES, ct.NEAR_TARGETS
        row["by_block_piece_targets"] = {}
        for block, piece, targets in NEAR_SPLITS:
            ct.NEAR_BLOCK, ct.NEAR_PIECE_BODIES, ct.NEAR_TARGETS = block, piece, targets
            ok = torch.allclose(kernel(), got, rtol=1e-4, atol=2e-6)
            row["by_block_piece_targets"][f"{block}x{piece}x{targets}"] = (
                time_ms(kernel, case["reps"]) if ok else float("nan"))
        ct.NEAR_BLOCK, ct.NEAR_PIECE_BODIES, ct.NEAR_TARGETS = keep
    return row


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
        row["max_abs_vs_before"] = float((a1["out"] - b1["out"]).abs().max())
        row["allclose_before"] = bool(torch.allclose(a1["out"], b1["out"], rtol=1e-4, atol=2e-6))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=pathlib.Path, default=None,
                    help="the root of another checkout to time beside this one")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sizes", default="8192,32768,65536,262144")
    ap.add_argument("--near", default="65536,524288,20480f,65536f,20480t")
    ap.add_argument("--json", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: needs a CUDA GPU")
    from n_body_problem_tpu_torch.ops import cuda_build

    cuda_build.load_library()
    log = (cuda_build.library_path().parent / "build.log").read_text()
    for job in log.split("$ ")[1:]:   # one nvcc command and its output each
        if job.splitlines()[0].endswith(("/symmetric.cu", "/near.cu")):
            for line in job.splitlines()[1:]:
                if any(w in line for w in ("registers", "spill", "Compiling entry")):
                    print(f"  ptxas| {line.strip()}")
    cases, rows = [], []
    for n in (int(x) for x in filter(None, args.sizes.split(","))):
        cases.append(symmetric_case(n))
        rows.append(symmetric_row(cases[-1]))
    for tok in filter(None, args.near.split(",")):
        cases.append(near_case(tok))
        rows.append(near_row(cases[-1], args.sweep))
    if args.before:
        in_turns(cases, rows, args.before.resolve())
    record = {"symmetric": [], "near": []}
    for case, row in zip(cases, rows):
        record[case["kernel"]].append(row)
        print(f"{case['kernel']} " + json.dumps(row), flush=True)
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
