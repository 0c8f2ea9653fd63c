"""The port's renderer against the JAX package's (``n_body_problem_tpu.render``).

The same bodies, made with numpy from a seed, go through both packages'
``project_to_screen`` and ``splat_frame``. The frames agree within rtol
1e-5 and atol 1e-6 x the frame's maximum: the deposits and the sprite
convolution are float32 sums taken in another order in each package. The
camera, the footprints, the tonemap and the PNG and PPM bytes are numpy in
both and must agree to the bit.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.render import camera as jcam
from n_body_problem_tpu.render import image as jimage
from n_body_problem_tpu.render import sprites as jsprites
from n_body_problem_tpu.render.splat import project_to_screen as jax_project
from n_body_problem_tpu.render.splat import splat_frame as jax_splat
from n_body_problem_tpu_torch.render import (
    FrameWriter,
    OrbitCamera,
    render_state,
    splat_frame,
    sprite_footprint,
    tonemap,
    write_png,
)
from n_body_problem_tpu_torch.render import camera as tcam
from n_body_problem_tpu_torch.render import image as timage
from n_body_problem_tpu_torch.render import sprites as tsprites
from n_body_problem_tpu_torch.render.image import to_host
from n_body_problem_tpu_torch.render.splat import project_to_screen
from n_body_problem_tpu_torch.render.sprites import MASS_THRESHOLD

FRAME_RTOL, FRAME_ATOL = 1e-5, 1e-6   # atol x the frame's maximum


def _scene(n, width, height, seed, scales=(0.0, 0.0, 0.0)):
    """``n`` bodies spread past every edge of the frame, both size classes,
    16 zero-mass padding bodies inside the frame, one body behind the camera
    and one on its plane (|w| < 1e-9) once divided by ``scales + 1``.
    Returns (pos, mass, real, camera)."""
    rng = np.random.default_rng(seed)
    cam = OrbitCamera(theta_deg=25.0, phi_deg=20.0, distance=3.0, aspect=width / height)
    pos = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.0, 2 * MASS_THRESHOLD, n).astype(np.float32)
    real = np.ones(n, bool)
    real[-16:] = False
    mass[-16:] = 0.0
    pos[-16:] *= 0.1
    eye = cam.eye()
    right = tcam.look_at(eye, np.zeros(3), cam.up)[0, :3]
    stretch = np.asarray(scales, np.float32) + 1.0
    pos[0] = 2.0 * eye * stretch                         # behind the camera
    pos[1] = (eye + 0.5 * right) * stretch               # on the camera plane
    return pos, mass, real, cam


def _jax_frame(pos, mass, real, cam, scales, width, height):
    return np.asarray(jax_splat(jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(real),
                                jnp.asarray(cam.view_projection()), jnp.asarray(scales),
                                width=width, height=height))


def _assert_frames_close(got, want):
    np.testing.assert_allclose(got, want, rtol=FRAME_RTOL, atol=FRAME_ATOL * want.max())


@pytest.mark.parametrize("scales", [(0.0, 0.0, 0.0), (3.0, 1.0, 2.0)])
def test_project_to_screen_matches_jax(scales):
    """px and py within 1e-3 px of JAX's, ``visible`` equal."""
    pos, _, _, cam = _scene(4096, 128, 96, seed=1, scales=scales)
    scales = np.asarray(scales, np.float32)
    want = jax_project(jnp.asarray(pos), jnp.asarray(cam.view_projection()),
                       jnp.asarray(scales), 128, 96)
    got = project_to_screen(torch.from_numpy(pos), cam.view_projection(), scales, 128, 96)
    px, py, vis = (np.asarray(w) for w in want)
    visible = got[2].numpy()
    np.testing.assert_array_equal(visible, vis)
    assert 0 < visible.sum() < len(pos)
    assert not visible[0] and not visible[1]
    np.testing.assert_allclose(got[0].numpy()[visible], px[vis], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy()[visible], py[vis], rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,width,height", [(500, 64, 64), (2048, 128, 96)])
def test_splat_frame_matches_jax(n, width, height):
    pos, mass, real, cam = _scene(n, width, height, seed=n)
    scales = np.zeros(3, np.float32)
    px, py, vis = (t.numpy() for t in project_to_screen(
        torch.from_numpy(pos), cam.view_projection(), scales, width, height))
    # The scene reaches the traps: taps off every edge (negative and too
    # large indices), the camera-plane body's pixel beyond int32, padding
    # and both classes among the drawn bodies.
    drawn = vis & real
    assert (px[drawn] < 0.5).any() and (px[drawn] > width - 0.5).any()
    assert (py[drawn] < 0.5).any() and (py[drawn] > height - 0.5).any()
    assert abs(px[1]) > 2**31 or abs(py[1]) > 2**31
    assert vis[~real].any()
    assert (mass[drawn] > MASS_THRESHOLD).any() and (mass[drawn] <= MASS_THRESHOLD).any()
    got = splat_frame(torch.from_numpy(pos), torch.from_numpy(mass), torch.from_numpy(real),
                      cam.view_projection(), scales, width=width, height=height)
    assert got.shape == (height, width, 3) and got.dtype == torch.float32
    want = _jax_frame(pos, mass, real, cam, scales, width, height)
    assert want.max() > 0
    _assert_frames_close(got.numpy(), want)


def test_render_state_matches_jax():
    """A reference-like scene (disk galaxy, scale factors) through both
    packages' ``render_state``."""
    from n_body_problem_tpu import models as jmodels
    from n_body_problem_tpu.render import render_state as jax_render_state

    js = jmodels.disk_galaxy(500, seed=0)
    cam = OrbitCamera(distance=2.0, phi_deg=30)
    want = np.asarray(jax_render_state(js, jcam.OrbitCamera(distance=2.0, phi_deg=30),
                                       scale_factors=(3, 3, 3), width=128, height=96))
    ts = tnb.make_state(np.array(js.pos), np.array(js.vel), np.array(js.mass))
    got = render_state(ts, cam, scale_factors=(3, 3, 3), width=128, height=96).numpy()
    _assert_frames_close(got, want)
    lit = got.sum(-1) > 1e-3      # golden hue: R > G > B wherever lit
    assert lit.any()
    assert (got[lit][:, 0] >= got[lit][:, 1]).all() and (got[lit][:, 1] >= got[lit][:, 2]).all()


def test_camera_and_footprints_bitwise():
    for theta, phi, dist in ((0.0, 0.0, 1.0), (25.0, 20.0, 3.0), (-170.0, 89.0, 0.5)):
        ours = tcam.OrbitCamera(theta_deg=theta, phi_deg=phi, distance=dist)
        theirs = jcam.OrbitCamera(theta_deg=theta, phi_deg=phi, distance=dist)
        np.testing.assert_array_equal(ours.view_projection(), theirs.view_projection())
    np.testing.assert_array_equal(tcam.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]),
                                  jcam.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]))
    np.testing.assert_array_equal(tcam.perspective(45.0, 1.5, 0.1, 100.0),
                                  jcam.perspective(45.0, 1.5, 0.1, 100.0))
    for size in (10, 15, 7):
        np.testing.assert_array_equal(tsprites.sprite_footprint(size),
                                      jsprites.sprite_footprint(size))
    np.testing.assert_array_equal(tsprites.stacked_footprints(), jsprites.stacked_footprints())
    np.testing.assert_array_equal(tsprites.GOLDEN_COLOR, jsprites.GOLDEN_COLOR)


def test_tonemap_and_image_bytes_bitwise(tmp_path):
    rng = np.random.default_rng(3)
    frame = rng.normal(0.5, 0.8, size=(24, 32, 3)).astype(np.float32)
    for exposure, background in ((1.0, 0.0), (0.37, 0.05)):
        np.testing.assert_array_equal(timage.tonemap(frame, exposure, background),
                                      jimage.tonemap(frame, exposure, background))
    img = timage.tonemap(frame)
    np.testing.assert_array_equal(timage.to_uint8(img), jimage.to_uint8(img))
    for name in ("write_png", "write_ppm"):
        getattr(timage, name)(tmp_path / "ours", img)
        getattr(jimage, name)(tmp_path / "theirs", img)
        assert (tmp_path / "ours").read_bytes() == (tmp_path / "theirs").read_bytes(), name
    timage.write_png(tmp_path / "ours", timage.to_uint8(img)[:, :, 0])   # grey
    jimage.write_png(tmp_path / "theirs", jimage.to_uint8(img)[:, :, 0])
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "theirs").read_bytes()


def test_splat_is_additive():
    """Two bodies = the sum of the single-body images (GL_ONE blending)."""
    cam = OrbitCamera(distance=3.0, aspect=1.0)
    kw = dict(width=64, height=64)
    p1 = torch.tensor([[0.2, 0.0, 0.0]])
    p2 = torch.tensor([[-0.2, 0.1, 0.0]])
    m = torch.tensor([0.5])
    one = torch.tensor([True])
    vp, sc = cam.view_projection(), (0.0, 0.0, 0.0)
    f1 = splat_frame(p1, m, one, vp, sc, **kw)
    f2 = splat_frame(p2, m, one, vp, sc, **kw)
    both = splat_frame(torch.cat([p1, p2]), torch.cat([m, m]), torch.tensor([True, True]),
                       vp, sc, **kw)
    torch.testing.assert_close(both, f1 + f2, rtol=0, atol=1e-5)


def test_splat_mass_size_classes():
    """Heavy bodies draw the 15 px sprite, light ones the 10 px sprite
    (vertex_shader.glsl:19-23)."""
    cam = OrbitCamera(distance=3.0, aspect=1.0)
    lit = []
    for m in (MASS_THRESHOLD * 2, MASS_THRESHOLD / 2):
        f = splat_frame(torch.zeros(1, 3), torch.tensor([m]), torch.tensor([True]),
                        cam.view_projection(), (0.0, 0.0, 0.0), width=64, height=64)
        lit.append(int((f.sum(-1) > 1e-6).sum()))
    assert lit[0] > lit[1] > 0


def test_padding_not_drawn():
    """Only real bodies rasterize (kernel.cu:1261 draws real_body_nums)."""
    state = tnb.pad_state(tnb.models.plummer(10, seed=0), multiple=16)
    state.pos[10:] = 0.0        # padding in the middle of the frame
    state.mass[10:] = 1.0
    cam = OrbitCamera(distance=5.0)
    frame_pad = render_state(state, cam, width=64, height=64)
    frame_real = render_state(tnb.unpad_state(state), cam, width=64, height=64)
    torch.testing.assert_close(frame_pad, frame_real, rtol=0, atol=1e-6)


def test_orbit_controls_match_reference():
    cam = OrbitCamera()
    cam.zoom(-1)       # wheel down -> x1.1 (kernel.cu:1017-1022)
    assert cam.distance == pytest.approx(1.1)
    cam.zoom(1)
    assert cam.distance == pytest.approx(0.99)
    cam.orbit(0, 10000)  # huge drag: phi clamps at +-89 (kernel.cu:1046)
    assert cam.phi_deg == -89.0


def test_png_roundtrip(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    img[2, 3] = [255, 128, 0]
    p = tmp_path / "t.png"
    write_png(p, img)
    raw = p.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    idat_start = raw.index(b"IDAT") + 4
    length = int.from_bytes(raw[idat_start - 8: idat_start - 4], "big")
    data = zlib.decompress(raw[idat_start: idat_start + length])
    row2 = data[2 * (8 * 3 + 1) + 1:][: 8 * 3]
    assert row2[9:12] == bytes([255, 128, 0])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_frame_writer(tmp_path, kind):
    """Frames as host arrays or as tensors: the writer thread copies them
    to the host itself (``to_host``), and writes what the JAX package's
    writer writes."""
    from n_body_problem_tpu.render import FrameWriter as JaxFrameWriter

    rng = np.random.default_rng(0)
    frames = [rng.random((16, 16, 3), dtype=np.float32) for _ in range(3)]
    with FrameWriter(tmp_path / "ours", exposure=0.5) as fw:
        for i, f in enumerate(frames):
            fw.submit(i, torch.from_numpy(f).requires_grad_() if kind == "torch" else f)
    with JaxFrameWriter(tmp_path / "theirs", exposure=0.5) as jfw:
        for i, f in enumerate(frames):
            jfw.submit(i, jnp.asarray(f))
    assert fw.frames_written == 3
    names = sorted(p.name for p in (tmp_path / "ours").glob("*.png"))
    assert names == ["frame_000000.png", "frame_000001.png", "frame_000002.png"]
    for name in names:
        assert ((tmp_path / "ours" / name).read_bytes()
                == (tmp_path / "theirs" / name).read_bytes())


def test_frame_writer_surfaces_errors_on_close(tmp_path):
    fw = FrameWriter(tmp_path)
    fw.submit(0, torch.zeros(4, 4, 2))      # two channels: write_png refuses
    with pytest.raises(ValueError, match="3 channels"):
        fw.close()


def test_to_host():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    out = to_host(t)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(to_host([[1.0, 2.0]]), [[1.0, 2.0]])
    np.testing.assert_array_equal(tonemap(to_host(torch.tensor([[-1.0, 0.5, 3.0]]))),
                                  [[0.0, 0.5, 1.0]])


def test_sprite_footprint_shape():
    k = sprite_footprint(15)
    assert k.shape == (15, 15) and k.max() > 0.5
    assert k[0, 0] == 0.0 and k[7, 7] == k.max()
