"""The port's live viewer: the cases of tests/test_server.py against
``n_body_problem_tpu_torch.render.server.LiveViewer``, and a frame submitted
as a torch tensor reaching ``/stream`` as a JPEG."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import json
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from n_body_problem_tpu_torch.render import OrbitCamera  # noqa: E402
from n_body_problem_tpu_torch.render.server import LiveViewer  # noqa: E402


def _wait_for_frame(v, frame_no=1):
    deadline = time.time() + 5
    while v._frame_no < frame_no and time.time() < deadline:
        time.sleep(0.01)
    assert v._frame_no >= frame_no, "encoder thread never produced the frame"


@pytest.fixture(scope="module")
def viewer():
    v = LiveViewer(0, OrbitCamera(distance=2.0))  # port 0: ephemeral
    frame = np.zeros((48, 64, 3), np.float32)
    frame[10:20, 20:40, :] = 1.0
    v.submit(frame)
    _wait_for_frame(v)
    yield v
    v.close()


def _get(viewer, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}", timeout=5)


def _one_jpeg(viewer) -> bytes:
    """One part of ``/stream``, parsed by its headers."""
    resp = _get(viewer, "/stream")
    assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
    assert resp.readline().strip() == b"--frame"
    headers = {}
    while True:
        line = resp.readline().strip()
        if not line:
            break
        k, v = line.split(b":", 1)
        headers[k.strip().lower()] = v.strip()
    assert headers[b"content-type"] == b"image/jpeg"
    body = resp.read(int(headers[b"content-length"]))
    assert body[:2] == b"\xff\xd8"  # JPEG SOI marker
    return body


def test_page_and_stats(viewer):
    body = _get(viewer, "/").read().decode()
    assert "/stream" in body and "orbit" in body
    stats = json.loads(_get(viewer, "/stats").read())
    assert "step" in stats and "ms_per_step" in stats


def test_stream_yields_jpeg(viewer):
    _one_jpeg(viewer)


def test_controls_mutate_camera(viewer):
    theta0 = viewer.camera.theta_deg
    dist0 = viewer.camera.distance
    _get(viewer, "/control?op=orbit&dx=50&dy=0").read()
    _get(viewer, "/control?op=zoom&s=1").read()
    assert viewer.camera.theta_deg != theta0
    assert viewer.camera.distance < dist0  # zoom in, x0.9 (kernel.cu:1016-1022)


def test_tensor_frame_reaches_the_stream(viewer, capfd):
    """A frame handed over as a tensor is copied to the host on the encoder
    thread (``to_host``) and served; nothing is reported as failed."""
    import io

    from PIL import Image

    frame = torch.zeros(48, 64, 3)
    frame[:, :32] = 1.0                       # left half white
    encoded = viewer._frame_no
    viewer.submit(frame.requires_grad_())
    _wait_for_frame(viewer, encoded + 1)
    img = np.asarray(Image.open(io.BytesIO(_one_jpeg(viewer))))
    assert img.shape == (48, 64, 3)
    assert img[:, :24].min() > 200 and img[:, 40:].max() < 50
    assert "frame encode failed" not in capfd.readouterr().err


def test_cli_serve_smoke(tmp_path):
    """run --serve end-to-end on the CPU: the viewer answers while the sim
    steps, and sees every block's step."""
    from n_body_problem_tpu_torch.cli import main

    holder = {}
    orig = LiveViewer.__init__

    def spy(self, port, camera, **kw):
        orig(self, port, camera, **kw)
        holder["viewer"] = self

    with socket.socket() as s:  # a free ephemeral port (--serve 0 = off)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    LiveViewer.__init__ = spy
    try:
        rc = main(["run", "--model", "plummer", "--n", "256", "--steps", "30",
                   "--solver", "direct", "--steps-per-block", "10",
                   "--serve", str(port), "--width", "64", "--height", "48",
                   "--device", "cpu", "--out", str(tmp_path)])
    finally:
        LiveViewer.__init__ = orig
    assert rc == 0
    v = holder["viewer"]
    assert v.port == port and v.stats["step"] == 30 and v.stats["n"] == 256
    _wait_for_frame(v)
    assert not (tmp_path / "frames").exists()   # --serve alone writes no PNGs


def test_viewer_without_pillow_refuses_to_start(monkeypatch):
    """Without Pillow the encoder could serve no frame: the viewer raises
    at construction instead of running with an empty stream."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        LiveViewer(0, OrbitCamera())
