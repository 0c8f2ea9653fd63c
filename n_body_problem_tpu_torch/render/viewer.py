"""Asynchronous host viewer: frames stream off-device without stalling
the step loop.

The reference's render is synchronous with physics — simulation rate is
tied to the GL frame rate (quirk Q8, ``kernel.cu:1191-1282``). Here frames
are device tensors handed to a writer thread; the device-to-host copies
(``image.to_host``) happen on that thread, overlapping the next simulation
steps, and PNG encoding happens entirely off the critical path.
"""

from __future__ import annotations

import pathlib
import queue
import threading

from n_body_problem_tpu_torch.render.image import to_host, tonemap, write_png


class FrameWriter:
    """Background PNG writer. ``submit`` returns immediately.

    >>> with FrameWriter("out/frames") as fw:
    ...     for i in range(100):
    ...         sim.run(10)
    ...         fw.submit(i, render_state(sim.state, cam, scales))
    """

    def __init__(
        self,
        out_dir: str | pathlib.Path,
        *,
        exposure: float = 1.0,
        pattern: str = "frame_{:06d}.png",
        max_queue: int = 8,
    ):
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.exposure = exposure
        self.pattern = pattern
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._errors: list[Exception] = []
        self.frames_written = 0
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            idx, frame = item
            try:
                img = tonemap(to_host(frame), exposure=self.exposure)
                write_png(self.out_dir / self.pattern.format(idx), img)
                self.frames_written += 1
            except Exception as e:  # surfaced on close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, index: int, frame) -> None:
        """Queue a device tensor or host array for writing (blocks only when the
        writer is more than ``max_queue`` frames behind)."""
        self._q.put((index, frame))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]

    def __enter__(self) -> "FrameWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def assemble_gif(
    frames_dir: str | pathlib.Path,
    out_path: str | pathlib.Path,
    fps: float = 25.0,
    pattern: str = "*.png",
) -> int:
    """Assemble written frames into an animated GIF (optional: needs PIL).

    Returns the number of frames; raises RuntimeError without PIL.
    """
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("GIF assembly needs Pillow; keep the PNG sequence") from e

    files = sorted(pathlib.Path(frames_dir).glob(pattern))
    if not files:
        return 0
    frames = [Image.open(f).convert("P", palette=Image.ADAPTIVE) for f in files]
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0,
    )
    return len(frames)
