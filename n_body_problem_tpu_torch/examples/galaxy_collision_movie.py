"""Two colliding galaxies, rendered to an animated GIF on the device.

    python -m n_body_problem_tpu_torch.examples.galaxy_collision_movie [out_dir]

Simulates the role of the reference's default dataset (dubinski.tab, two
galaxies on a collision course) with the procedural generator, renders
each block's frames on the device (``Simulation.movie``), writes them as
PNGs on a background thread and assembles ``movie.gif`` (needs Pillow).
"""

from __future__ import annotations

import argparse
import pathlib

import n_body_problem_tpu_torch as nb
from n_body_problem_tpu_torch.render import FrameWriter, OrbitCamera
from n_body_problem_tpu_torch.render.viewer import assemble_gif


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m n_body_problem_tpu_torch.examples.galaxy_collision_movie")
    ap.add_argument("out", nargs="?", default="out/collision")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = nb.SimConfig(dt=0.004, integrator="leapfrog", morton_sort=True)
    state = nb.models.galaxy_collision(args.n, seed=0)
    sim = nb.Simulation(cfg, state, device=args.device)
    camera = OrbitCamera(phi_deg=25.0, distance=1.0, aspect=4 / 3)

    frames_dir = out / "frames"
    with FrameWriter(frames_dir, exposure=0.8) as fw:
        idx = 0
        for _ in range(args.blocks):
            # 20 frames a block, 5 steps a frame
            frames = sim.movie(100, render_every=5, camera=camera,
                               scale_factors=(7, 7, 7), width=640, height=480)
            for f in frames:
                fw.submit(idx, f)
                idx += 1
            print(f"step {int(sim.state.step)}: {idx} frames")

    n = assemble_gif(frames_dir, out / "movie.gif", fps=20)
    print(f"wrote {out / 'movie.gif'} ({n} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
