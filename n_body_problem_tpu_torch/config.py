"""Simulation configuration.

The reference hardcodes every knob as a compile-time ``#define``
(``kernel.cu:62-73``: G=1, TIME_TICK=0.008, BLOCK_SIZE=256, EPSILON=1e-6,
VERSION selecting the solver). Here the same knobs live in a single frozen
dataclass that is hashable and can be loaded from JSON/TOML or overridden
from the CLI.

This module is a copy of ``n_body_problem_tpu.config`` (which is JAX-free):
field names, defaults and solver strings are identical, so a config or a
checkpoint written by either package loads in the other. In this package
``"pallas"`` names the hand-written CUDA all-pairs kernel
(``ops/cuda_force.py``) and ``"pallas_symmetric"`` the hand-written CUDA
half-pair kernel (``ops/cuda_symmetric.py``); ``"auto"`` picks between them
on a CUDA device and resolves to ``"mxu"`` on the CPU
(``ops/registry.py``). ``"treecode"`` is the treecode (``ops/treecode.py``)
on its hierarchical, flat or dense path, on the CUDA kernels of
``ops/cuda_treecode.py``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

def resolve_vip_tiles(vip_tiles: int, n: int) -> int:
    """-1 (auto) -> clamp(n // 2048, 16, 128) 32-body VIP units: ~n/64
    exact-evaluated halo bodies, the measured cost/error optimum from
    32,768 to 524,288 (a fixed 4,096-body budget was 10% of the step at
    N=65,536 for no error gain)."""
    if vip_tiles != -1:
        return vip_tiles
    return max(16, min(128, n // 2048))


def tuned_tree_overrides(n: int) -> dict[str, Any]:
    """Measured per-N treecode overrides (one v5e, 2026-08-18 sweep,
    ``tools/tune_small_n.py``; defaults stay untouched — callers opt in
    via ``SimConfig(solver="treecode", **tuned_tree_overrides(n))``,
    the CLI's ``--tree-tuned``, or bench.py's small-N legs).

    Below ~32k bodies the flat-path near/far balance shifts: the
    32-body source tile halves near pair work for +44% (cheap) far
    evals and a 32-step rebuild cadence amortizes the (relatively
    large at small N) build. At the reference's own N=20,480 a looser
    tau (5e-4) additionally stays inside the ~1e-3 p99 class of the
    flagship legs (measured 1.15e-3) for 2.57 -> 1.79 ms/step; at
    24k-32k the same tau measured ~4e-3 p99, so that bracket keeps
    the default tau (0.93x baseline at 24,576, p99 1.7e-3). Large N
    keeps the tuned defaults entirely (the sweep's tile/tau/src
    changes regressed there — src32 at 262k: 76.3 vs 72.6 ms/step).
    """
    if n <= 20480:
        return {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                "tree_rebuild_every": 32, "tree_near_slack": 4}
    if n <= 32768:
        return {"tree_src_tile": 32, "tree_rebuild_every": 32,
                "tree_near_slack": 4}
    return {}


SOLVERS = (
    "auto",        # pallas on TPU, mxu elsewhere
    "direct",      # one-shot jnp O(N^2); the serial ground truth (kernel.cu:891-923 role)
    "blocked",     # lax.map over row blocks; memory-safe pure-XLA O(N^2)
    "mxu",         # matmul formulation: Gram-matrix r^2 + W@P accumulation on the MXU
    "pallas",      # Pallas blocked all-pairs kernel (kernel.cu:828-884 role, TPU-native)
    "pallas_symmetric",  # Pallas half-pair symmetric kernel (the report's method, kernel.cu:703-774 role)
    "treecode",    # Barnes-Hut on the Morton tiling: beyond-brute-force, ~1e-4 median force error
    "pair_matrix", # dev-history Method A foil (project_develop_code.cu:657-861); small N only
)

INTEGRATORS = (
    "semi_implicit_euler",  # v += a*dt; x += v*dt  (kernel.cu:777-801)
    "leapfrog",             # KDK leapfrog (dev-history capability, project_develop_code.cu:831-859)
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All physics + execution knobs for a simulation.

    Numerical defaults reproduce the reference's method C
    (``cal_single_acclerate_without_mass_new``, ``kernel.cu:665-692``):
    pair separation is scaled by ``compensate`` = 0.1 before squaring and the
    raw ``eps2`` = 1e-6 is added to the *scaled* square distance, which is
    algebraically a Plummer softening with effective eps'^2 = eps2/compensate^2
    = 1e-4 while keeping fp32 intermediates well-scaled.
    """

    # --- physics (kernel.cu:62-66) ---
    dt: float = 0.008          # TIME_TICK
    G: float = 1.0
    eps2: float = 1e-6         # EPSILON, added to the *scaled* squared distance
    compensate: float = 0.1    # separation pre-scale; 1.0 => plain Plummer softening with eps2

    # --- solver / integrator selection (VERSION, kernel.cu:70-73) ---
    solver: str = "auto"
    integrator: str = "semi_implicit_euler"

    # --- execution ---
    block_size: int = 256      # row-chunk for blocked/mxu solvers (BLOCK_SIZE analogue)
    pallas_tile_i: int = 256   # Pallas row tile (sublane dim)
    pallas_tile_j: int = 1024  # Pallas column tile (lane dim)
    pallas_sym_tile: int = 512          # symmetric-kernel square tile
    pallas_sym_precision: str = "f32"   # "f32" exact | "bf16x3" fast-math
    # --- treecode solver (ops/treecode.py; requires Morton-sorted bodies,
    # Simulation auto-enables morton_sort for it) ---
    tree_tile: int = 0         # target-row Morton tile (output granularity);
                               # 0 = auto: 128 on the hierarchical flat path
                               # (near-work is flat in the row size there —
                               # measured — and wide rows feed the far
                               # kernel), 32 otherwise
    tree_src_tile: int = 64    # SOURCE tile of the flat path (asymmetric
                               # acceptance: bigger sources shrink the
                               # bookkeeping, thicken the exact near shell;
                               # 64 measured fastest at N=262k with p99
                               # error equal to 128's on the same state)
    tree_theta: float = 0.55   # geometric opening angle (used when
                               # tree_mac_tau == 0)
    tree_mac_tau: float = 2e-4 # mass-aware MAC tolerance: open a source
                               # tile iff its estimated quadrupole-
                               # truncation error exceeds tau x the median
                               # body acceleration. ~2x more accurate than
                               # the theta test at matched cost (measured);
                               # 0 falls back to the geometric criterion.
    tree_max_near: int = 0     # near-list capacity; 0 = auto-tune at init
                               # (in source tiles on the flat path)
    tree_vip_tiles: int = -1   # largest-radius tiles evaluated exactly,
                               # counted in 32-body units (see
                               # ops.treecode._vip_src_tiles). -1 = auto:
                               # clamp(N // 2048, 16, 128) — the measured
                               # optimum ~N/64 exact bodies (65k sweep:
                               # 1,024 bodies beat 4,096 by 1.3 ms/step at
                               # equal p99). 0 disables the VIP split.
    tree_rebuild_every: int = 8   # device re-sort + acceptance rebuild
                                  # cadence inside Simulation.run (near
                                  # counts grow ~12% over 8 steps; the
                                  # suggest_max_near margin covers it)
    tree_near_slack: int = 8   # extra exact SOURCE tiles per target (flat
                               # path headroom for inter-rebuild drift)
    tree_flat_cap: int = 0     # compacted work-list capacity; 0 = auto on
                               # TPU (mean-bound near cost), -1 = disable
    tree_hier: bool = True     # multi-level far field on the flat path:
                               # binary merge hierarchy + compacted far
                               # lists + octupole-bound MAC (round 3); off
                               # falls back to the single-level masked far
    tree_hier_tau: float = 0.01  # hierarchical MAC tolerance: open a node
                               # iff m rms^2 r_max / (d - r_max)^5 exceeds
                               # tau x the median body acceleration. Own
                               # scale (the convergence-aware distance
                               # changes the score's units of magnitude);
                               # calibrated on the measured per-node error
                               # frontier (docs/acceptance.md). 0 falls
                               # back to the geometric theta criterion.
    tree_far_cap: int = 0      # hierarchical far-list capacity; 0 = auto
    tree_far_max: int = 0      # per-target far-list bound; 0 = auto
    tree_hier_union: bool = True  # per-body union distances at COARSE
                               # levels too (not just level 0): the cheap
                               # com-minus-row-radius bound collapses for
                               # wide halo target rows (everything opens
                               # to the leaves). Census at N=262k: mean
                               # far evals -26%, worst row -60%, for ~2x
                               # the build's (amortized) distance work
                               # (docs/acceptance.md round-3 union table).
    # (Physics is fp32 throughout — the reference's `real`; no dtype knob.)
    morton_sort: bool = False  # Z-order bodies at init (tile locality)
    resort_every: int = 0      # >0: sort at init AND re-sort every N steps
                               # of Simulation.run (trajectory/movie are
                               # single device programs and never re-sort)
    donate: bool = True        # donate state buffers through jitted scans

    # --- guards / diagnostics (dev-history D4: project_develop_code.cu:1089-1091) ---
    vmax_guard: float = 0.0    # if > 0, diagnostics.overspeed_count uses this threshold

    def __post_init__(self) -> None:
        if self.solver not in SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; expected one of {SOLVERS}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"unknown integrator {self.integrator!r}; expected one of {INTEGRATORS}"
            )
        if self.compensate <= 0:
            raise ValueError("compensate must be > 0")
        if self.eps2 <= 0:
            # eps2 = 0 turns the self-pair into 0 * inf = NaN; the reference
            # relies on EPSILON > 0 for the same reason (kernel.cu:66, 679).
            raise ValueError("eps2 must be > 0")
        if self.pallas_sym_precision not in ("f32", "bf16x3", "mixed"):
            raise ValueError(
                f"unknown pallas_sym_precision {self.pallas_sym_precision!r}; "
                "expected 'f32', 'bf16x3' or 'mixed'"
            )
        if not (0.0 < self.tree_theta <= 1.0):
            raise ValueError(f"tree_theta must be in (0, 1], got {self.tree_theta}")
        if self.tree_max_near < 0 or self.tree_vip_tiles < -1:
            raise ValueError(
                "tree_max_near must be >= 0 and tree_vip_tiles >= -1 "
                "(-1 = auto)")
        if self.tree_mac_tau < 0:
            raise ValueError(f"tree_mac_tau must be >= 0, got {self.tree_mac_tau}")
        if self.tree_hier_tau < 0:
            raise ValueError(
                f"tree_hier_tau must be >= 0, got {self.tree_hier_tau}")
        if self.tree_tile and (self.tree_src_tile % self.tree_tile
                               and self.tree_tile % self.tree_src_tile):
            raise ValueError(
                f"tree_src_tile ({self.tree_src_tile}) and tree_tile "
                f"({self.tree_tile}) must be multiples of one another"
            )
        if self.tree_rebuild_every < 1:
            raise ValueError("tree_rebuild_every must be >= 1")

    # Effective Plummer softening (added to the unscaled squared distance).
    @property
    def eps2_effective(self) -> float:
        return self.eps2 / (self.compensate * self.compensate)

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "SimConfig":
        path = pathlib.Path(path)
        text = path.read_text()
        if path.suffix in (".toml", ".tml"):
            import tomllib

            return cls.from_dict(tomllib.loads(text))
        return cls.from_dict(json.loads(text))

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_dict(), indent=2))
