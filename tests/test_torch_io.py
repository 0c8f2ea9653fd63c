"""The port's dataset I/O against the JAX package's, on the CPU.

Both packages parse with numpy (or the same C++ parser), so every
comparison with the JAX package is bitwise: same arrays, same dtypes. The
round-trip tests are those of tests/test_io.py that need no reference data,
with the same tolerances; the golden tests take the ``reference_data_dir``
fixture and skip where the reference's data files are not mounted, as the
JAX ones do.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import dataclasses

import numpy as np
import pytest

import n_body_problem_tpu.io as jio
from n_body_problem_tpu.io.checkpoint import export_snap as jax_export_snap
from n_body_problem_tpu.io.text import BodyData as JBodyData
from n_body_problem_tpu.state import to_numpy as jax_to_numpy
from n_body_problem_tpu_torch import models
from n_body_problem_tpu_torch.io import (
    DATASETS,
    load_dataset,
    read_csv,
    read_dat,
    read_snap,
    read_tab,
    read_tipsy,
    tipsy_to_csv,
    write_snap,
    write_tab,
    write_tipsy,
)
from n_body_problem_tpu_torch.io import native
from n_body_problem_tpu_torch.io.checkpoint import export_snap
from n_body_problem_tpu_torch.io.text import BodyData
from n_body_problem_tpu_torch.state import to_numpy


def _body_data(n, seed, cls=BodyData, eps=0.0, time=0.0):
    s = models.plummer(n, seed=seed)
    return cls(pos=s.pos.numpy(), vel=s.vel.numpy(), mass=s.mass.numpy(),
               eps=np.full(n, eps, np.float32), time=time)


def _assert_same(a, b, fields=("pos", "vel", "mass", "eps")):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_same_state(jax_state, torch_state):
    dj, dt = jax_to_numpy(jax_state), to_numpy(torch_state)
    assert set(dj) == set(dt)
    for k in dj:
        assert dj[k].dtype == dt[k].dtype, k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)


# ------------------------------------------------------------ round-trips
def test_tipsy_roundtrip(tmp_path):
    state = models.plummer(100, seed=0)
    p = tmp_path / "t.bin"
    pos, vel, mass = (x.numpy() for x in (state.pos, state.vel, state.mass))
    eps = np.full(100, 0.01, np.float32)
    write_tipsy(p, pos, vel, mass, eps, time=2.5, n_dark=30)
    d = read_tipsy(p)
    assert d.time == 2.5 and d.n_dark == 30 and d.n_star == 70
    np.testing.assert_allclose(d.pos, pos, rtol=1e-6)
    np.testing.assert_allclose(d.vel, vel, rtol=1e-6)
    np.testing.assert_allclose(d.mass, mass, rtol=1e-6)
    np.testing.assert_allclose(d.eps, eps, rtol=1e-6)
    assert d.to_state().pos.device.type == "cpu"


def test_tipsy_rejects_bad_files(tmp_path):
    p = tmp_path / "short.bin"
    p.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="too short"):
        read_tipsy(p)
    s = models.plummer(8, seed=0)
    write_tipsy(p, s.pos.numpy(), s.vel.numpy(), s.mass.numpy())
    p.write_bytes(p.read_bytes()[:-4])
    with pytest.raises(ValueError, match="size"):
        read_tipsy(p)


def test_tab_roundtrip(tmp_path):
    data = _body_data(64, seed=1)
    p = tmp_path / "t.tab"
    write_tab(p, data)
    d = read_tab(p)
    np.testing.assert_allclose(d.pos, data.pos, rtol=1e-5)
    np.testing.assert_allclose(d.mass, data.mass, rtol=1e-5)


def test_tab_trailing_body_quirk(tmp_path):
    p = tmp_path / "t.tab"
    p.write_text("1.0 1 2 3 4 5 6\n2.0 7 8 9 10 11 12\n")
    clean = read_tab(p)
    quirky = read_tab(p, quirk_trailing_body=True)
    assert clean.n == 2
    assert quirky.n == 3  # Q3: the eof re-parse duplicates the last body
    np.testing.assert_array_equal(quirky.pos[2], quirky.pos[1])


def test_dat_axis_order(tmp_path):
    p = tmp_path / "t.dat"
    # z y x vz vy vx (kernel.cu:387): body at x=3, y=2, z=1; v=(6,5,4)
    p.write_text("1 2 3 4 5 6\n\n")  # plus a blank line to skip
    d = read_dat(p)
    assert d.n == 1
    np.testing.assert_array_equal(d.pos[0], [3.0, 2.0, 1.0])
    np.testing.assert_array_equal(d.vel[0], [6.0, 5.0, 4.0])
    assert d.mass[0] == 1.0


def test_snap_roundtrip(tmp_path):
    data = _body_data(32, seed=2, eps=0.05, time=9.5)
    p = tmp_path / "t.snap"
    write_snap(p, data)
    d = read_snap(p)
    assert d.time == 9.5 and d.n == 32
    np.testing.assert_allclose(d.pos, data.pos, rtol=1e-5)
    np.testing.assert_allclose(d.eps, data.eps, rtol=1e-5)


def test_snap_rejects_truncated(tmp_path):
    p = tmp_path / "t.snap"
    p.write_text("4\n3\n0.0\n1\n1\n")
    with pytest.raises(ValueError, match="truncated"):
        read_snap(p)


def test_export_snap_reimport(tmp_path):
    state = models.plummer(40, seed=4)
    p = tmp_path / "out.snap"
    export_snap(p, state)
    d = read_snap(p)
    assert d.n == 40
    np.testing.assert_allclose(d.pos, state.pos.numpy(), rtol=1e-5)


def test_export_snap_drops_padding_and_matches_jax(tmp_path):
    """Only the real bodies are written, and the file is the JAX package's
    byte for byte."""
    import n_body_problem_tpu as jnb
    from n_body_problem_tpu_torch.state import from_numpy, pad_state

    js = jnb.pad_state(jnb.models.plummer(40, seed=4), multiple=64)
    ts = pad_state(from_numpy(jax_to_numpy(jnb.models.plummer(40, seed=4))), multiple=64)
    assert ts.n == 64 and ts.n_real == 40
    export_snap(tmp_path / "t.snap", ts)
    jax_export_snap(tmp_path / "j.snap", js)
    assert (tmp_path / "t.snap").read_bytes() == (tmp_path / "j.snap").read_bytes()
    assert read_snap(tmp_path / "t.snap").n == 40


# ------------------------------------------------------- native vs python
def test_native_parser_matches_python(tmp_path, monkeypatch):
    p = tmp_path / "t.tab"
    rows = ["1.5 1 2 3 -4e-2 5E+1 6", "  ", "2.5 -7 8.25 9 10 11 12"]
    p.write_text("\n".join(rows) + "\n")

    monkeypatch.setenv("NBODY_NO_NATIVE", "1")
    py = read_tab(p)
    assert native.parse_table(p, 7) is None
    monkeypatch.delenv("NBODY_NO_NATIVE")

    if not native.available():
        pytest.skip("native toolchain unavailable")
    nat = native.parse_table(p, 7, skip_blank=True)
    assert nat.shape == (2, 7)
    np.testing.assert_allclose(nat[:, 1:4], py.pos, rtol=1e-6)
    np.testing.assert_allclose(nat[:, 0], py.mass, rtol=1e-6)


@pytest.mark.parametrize("fmt", ["tab", "dat", "snap"])
def test_native_and_python_readers_agree_bitwise(tmp_path, monkeypatch, fmt):
    """Both parsers round a printed %.7g value to the same float32."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    data = _body_data(50, seed=6, eps=0.02, time=1.25)
    p = tmp_path / f"t.{fmt}"
    if fmt == "snap":
        write_snap(p, data)
        reader = read_snap
    else:
        write_tab(p, data)   # dat reads the first 6 columns of the same table
        reader = read_tab if fmt == "tab" else read_dat
    nat = reader(p)
    monkeypatch.setenv("NBODY_NO_NATIVE", "1")
    py = reader(p)
    _assert_same(nat, py)


def test_native_library_is_built_from_the_port(tmp_path):
    """The port builds its own copy of the parser, never the JAX package's."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    assert native.LIB_PATH.parent.parent.name == "n_body_problem_tpu_torch"
    assert native.LIB_PATH.is_file() and native.SOURCE.is_file()


# --------------------------------------------- the two packages' files
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_tipsy_cross_package_bitwise(tmp_path, writer):
    s = models.plummer(77, seed=3)
    args = (s.pos.numpy(), s.vel.numpy(), s.mass.numpy(),
            np.linspace(0, 0.01, 77, dtype=np.float32), np.arange(77, dtype=np.int32)[::-1])
    p = tmp_path / "t.bin"
    (write_tipsy if writer == "torch" else jio.write_tipsy)(p, *args, time=1.5, n_dark=20)
    a, b = read_tipsy(p), jio.read_tipsy(p)
    _assert_same(a, b, ("pos", "vel", "mass", "eps", "ids"))
    assert (a.time, a.n_dark, a.n_star) == (b.time, b.n_dark, b.n_star)
    _assert_same_state(b.to_state(), a.to_state())


@pytest.mark.parametrize("fmt", ["tab", "snap"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_text_cross_package_bitwise(tmp_path, fmt, writer):
    data = _body_data(50, seed=5, eps=0.03, time=2.75)
    jdata = JBodyData(**dataclasses.asdict(data))
    p = tmp_path / f"t.{fmt}"
    write = {("tab", "torch"): lambda: write_tab(p, data),
             ("tab", "jax"): lambda: jio.write_tab(p, jdata),
             ("snap", "torch"): lambda: write_snap(p, data),
             ("snap", "jax"): lambda: jio.write_snap(p, jdata)}
    write[fmt, writer]()
    read_t, read_j = (read_tab, jio.read_tab) if fmt == "tab" else (read_snap, jio.read_snap)
    a, b = read_t(p), read_j(p)
    _assert_same(a, b)
    assert a.time == b.time
    _assert_same_state(b.to_state(), a.to_state())


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_csv_cross_package_bitwise(tmp_path, writer):
    s = models.plummer(60, seed=7)
    write_tipsy(tmp_path / "t.bin", s.pos.numpy(), s.vel.numpy(), s.mass.numpy(),
                np.full(60, 0.01, np.float32), n_dark=10)
    out = tmp_path / "t.csv"
    convert = tipsy_to_csv if writer == "torch" else jio.tipsy_to_csv
    assert convert(tmp_path / "t.bin", out) == 60
    other = tmp_path / "o.csv"
    (jio.tipsy_to_csv if writer == "torch" else tipsy_to_csv)(tmp_path / "t.bin", other)
    assert out.read_bytes() == other.read_bytes()
    a, b = read_csv(out), jio.read_csv(out)
    _assert_same(a, b)
    t = read_tipsy(tmp_path / "t.bin")
    np.testing.assert_allclose(a.pos, t.pos, rtol=1e-4)
    np.testing.assert_allclose(a.mass, t.mass, rtol=1e-4)


# ------------------------------------------------------ dataset registry
def test_registry_equals_jax_field_for_field():
    from n_body_problem_tpu.io.datasets import DEFAULT_DATASET as JAX_DEFAULT
    from n_body_problem_tpu_torch.io.datasets import DEFAULT_DATASET

    assert DEFAULT_DATASET == JAX_DEFAULT == 1
    assert sorted(DATASETS) == sorted(jio.DATASETS) == list(range(6))
    for i, spec in DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jio.DATASETS[i]), i


def test_data_dir_reads_the_environment(monkeypatch, tmp_path):
    from n_body_problem_tpu_torch.io.datasets import data_dir

    monkeypatch.delenv("NBODY_DATA_DIR", raising=False)
    assert str(data_dir()) == "data"
    monkeypatch.setenv("NBODY_DATA_DIR", str(tmp_path))
    assert data_dir() == tmp_path


def _synthetic_files(d):
    """Files of datasets 0 (tipsy), 1 (tab), 3 (dat) and 4 (snap)."""
    data = _body_data(96, seed=8, eps=0.01, time=9.5)
    write_tipsy(d / "galaxy_20K.bin", data.pos, data.vel, data.mass, data.eps, n_dark=12)
    write_tab(d / "dubinski.tab", data)
    np.savetxt(d / "stars.dat", np.concatenate([data.pos[:, ::-1], data.vel[:, ::-1]], 1),
               fmt="%.7g")
    write_snap(d / "k17c.snap", data)


@pytest.mark.parametrize("dataset_id, quirk", [(0, False), (1, False), (3, False),
                                               (4, False), (4, True)])
def test_load_dataset_files_match_jax_bitwise(tmp_path, dataset_id, quirk):
    _synthetic_files(tmp_path)
    ts, tspec = load_dataset(dataset_id, directory=tmp_path, quirk_compat=quirk)
    js, jspec = jio.load_dataset(dataset_id, directory=tmp_path, quirk_compat=quirk)
    assert tspec == DATASETS[dataset_id] and ts.pos.device.type == "cpu"
    _assert_same_state(js, ts)
    # Q1: through the dat reader every line of the snap file is a body: the 3
    # header lines and 4 lines a body (mass, position, velocity, softening)
    assert ts.n_real == (3 + 4 * 96 if quirk else 96)


def test_load_dataset_padding_and_clamp_match_jax(tmp_path):
    _synthetic_files(tmp_path)
    for kw in (dict(pad_reference_style=True), dict(max_bodies=50),
               dict(max_bodies=50, pad_reference_style=True), dict(max_bodies=500)):
        ts, _ = load_dataset(0, directory=tmp_path, **kw)
        js, _ = jio.load_dataset(0, directory=tmp_path, **kw)
        _assert_same_state(js, ts)
    ts, _ = load_dataset(0, directory=tmp_path, pad_reference_style=True)
    assert (ts.n, ts.n_real) == (257, 96)   # ceil(96/256)*256 + 1 (kernel.cu:260-278)


# 81,920 stars + 2 bulge particles; 65,535 disk stars + 1 bulge
@pytest.mark.parametrize("dataset_id, n_real", [(1, 81922), (2, 65536)])
def test_dataset_fallback_matches_jax_bitwise(tmp_path, dataset_id, n_real):
    ts, spec = load_dataset(dataset_id, directory=tmp_path, seed=1)
    js, _ = jio.load_dataset(dataset_id, directory=tmp_path, seed=1)
    assert spec.reader == "tab" and ts.n_real == n_real
    _assert_same_state(js, ts)


def test_dataset_without_fallback_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no procedural fallback"):
        load_dataset(0, directory=tmp_path)
    with pytest.raises(ValueError, match="not in"):
        load_dataset(6, directory=tmp_path)


# ------------------------------------------------------ reference golden
def test_reference_tipsy_header(reference_data_dir):
    d = read_tipsy(reference_data_dir / "galaxy_20K.bin")
    assert d.time == 0.0
    assert d.n_dark == 2500 and d.n_star == 17500
    assert len(d.mass) == 20000
    assert np.isfinite(d.pos).all() and np.isfinite(d.vel).all()


def test_reference_snap_headers(reference_data_dir):
    d = read_snap(reference_data_dir / "k17c.snap")
    assert d.n == 32770 and d.time == pytest.approx(9.5)
    d2 = read_snap(reference_data_dir / "k17hp.snap")
    assert d2.n == 10002 and d2.time == pytest.approx(7.75)


def test_reference_datasets_match_jax(reference_data_dir):
    for i in (0, 3, 4, 5):
        ts, _ = load_dataset(i, directory=reference_data_dir)
        js, _ = jio.load_dataset(i, directory=reference_data_dir)
        _assert_same_state(js, ts)
    q, _ = load_dataset(4, directory=reference_data_dir, quirk_compat=True)
    assert q.n_real == 131083  # 3 + 4*32770 value lines (file lacks a final \n)


def test_converter_matches_reference_csv(reference_data_dir, tmp_path):
    out = tmp_path / "out.csv"
    n = tipsy_to_csv(reference_data_dir / "galaxy_20K.bin", out)
    assert n == 20000
    ours = out.read_text().splitlines()
    theirs = (reference_data_dir / "galaxy_20k.csv").read_text().splitlines()
    assert ours[0] == theirs[0]
    for i in (1, 2, 100, 20000):
        a = np.array(ours[i].split(","), dtype=np.float64)
        b = np.array(theirs[i].split(","), dtype=np.float64)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
