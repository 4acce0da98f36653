"""nbody_tpu_torch's dumps, checkpoints, native host runtime, structure
telemetry and initial-condition device rule against nbody_tpu, on the
same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu import config as jcfg
from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.utils import io as jio, metrics as jmetrics

from nbody_tpu_torch import config as tcfg, init as tinit
from nbody_tpu_torch.convert import state_from_numpy, state_to_numpy
from nbody_tpu_torch.native import runtime as tnative
from nbody_tpu_torch.utils import io as tio, metrics as tmetrics

torch.set_num_threads(2)


def _arrays(n, seed=42):
    st = disk_galaxy_msvc(n, seed)
    pos, vel, mass = (np.array(x) for x in st[:3])
    acc = np.random.default_rng(seed).normal(0, 50, (n, 3)).astype(np.float32)
    return pos, vel, mass, acc


def _native_off(monkeypatch):
    """Both packages' dump writers without their native runtimes."""
    monkeypatch.setattr(jio, "_native_writer", lambda: None)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.mark.parametrize("positions_only", [False, True])
def test_dump_bytes_identical_to_jax(tmp_path, monkeypatch, positions_only):
    """The native and the numpy writer of each package write the same
    bytes for the same arrays (header, %.6f rows, negative zeros)."""
    pos, vel, mass, acc = _arrays(500)
    pos[0] = [-0.0, 1e-9, -1e-9]
    vel[1] = [-0.0000004, 123456.5, -7.25]
    cj, ct = jcfg.SimConfig(n=500, dt=0.03), tcfg.SimConfig(n=500, dt=0.03)
    paths = {}
    assert tnative.available(), tnative.status()
    paths["jax_native"] = tmp_path / "jn.txt"
    jio.dump_state_text(str(paths["jax_native"]), JState.create(pos, vel, mass),
                        cj, 17, positions_only=positions_only)
    paths["torch_native"] = tmp_path / "tn.txt"
    tio.dump_state_text(str(paths["torch_native"]),
                        state_from_numpy(pos, vel, mass, device="cpu"), ct, 17,
                        positions_only=positions_only)
    _native_off(monkeypatch)
    paths["jax_numpy"] = tmp_path / "jp.txt"
    jio.dump_state_text(str(paths["jax_numpy"]), JState.create(pos, vel, mass),
                        cj, 17, positions_only=positions_only)
    paths["torch_numpy"] = tmp_path / "tp.txt"
    with pytest.warns(RuntimeWarning, match="with numpy"):
        tio.dump_state_text(str(paths["torch_numpy"]),
                            state_from_numpy(pos, vel, mass, device="cpu"),
                            ct, 17, positions_only=positions_only)
    blobs = {k: p.read_bytes() for k, p in paths.items()}
    assert len(set(blobs.values())) == 1, [k for k in blobs]
    lines = blobs["torch_native"].decode().splitlines()
    assert len(lines) == 504
    assert lines[2] == "# Bodies: 500, Theta: 0.50, dt: 0.030"
    assert len(lines[4].split()) == (3 if positions_only else 6)


def test_load_dump_of_both_packages(tmp_path):
    pos, vel, mass, _ = _arrays(300)
    ct, cj = tcfg.SimConfig(n=300), jcfg.SimConfig(n=300)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tio.dump_state_text(pt, state_from_numpy(pos, vel, mass, device="cpu"), ct,
                        5)
    jio.dump_state_text(pj, JState.create(pos, vel, mass), cj, 5)
    for path in (pt, pj):
        meta_t, rows_t = tio.load_dump(path)
        meta_j, rows_j = jio.load_dump(path)
        assert meta_t == meta_j == {"bodies": 300.0, "theta": 0.5, "dt": 0.02}
        np.testing.assert_array_equal(rows_t, rows_j)
        assert rows_t.shape == (300, 6)
        np.testing.assert_allclose(rows_t[:, :3], pos, atol=5e-7)
    # the native parser reads the same rows
    np.testing.assert_array_equal(tnative.load_dump(pt, 1000, 6),
                                  tio.load_dump(pt)[1])


def test_npz_checkpoints_cross_load(tmp_path, monkeypatch):
    pos, vel, mass, acc = _arrays(200)
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_checkpoint(pt, state_from_numpy(pos, vel, mass, acc,
                                             device="cpu"), step=13)
    jio.save_checkpoint(pj, JState.create(pos, vel, mass, acc), step=21)
    with np.load(pt) as zt, np.load(pj) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
    js, jstep = jio.load_checkpoint(pt)            # port -> JAX
    ts, tstep = tio.load_checkpoint(pj, device="cpu")   # JAX -> port
    assert (jstep, tstep) == (13, 21)
    for got, want in zip(state_to_numpy(ts), (pos, vel, mass, acc)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(js, (pos, vel, mass, acc)):
        np.testing.assert_array_equal(np.asarray(got), want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_checkpoint(pj)                 # CUDA unless asked


def test_torch_save_checkpoint_round_trip(tmp_path):
    pos, vel, mass, acc = _arrays(128)
    path = str(tmp_path / "ck.pt")
    tio.save_checkpoint_torch(path, state_from_numpy(pos, vel, mass, acc,
                                                     device="cpu"), step=7)
    st, step = tio.load_checkpoint_torch(path, device="cpu")
    assert step == 7
    for got, want in zip(state_to_numpy(st), (pos, vel, mass, acc)):
        np.testing.assert_array_equal(got, want)


def test_native_runtime_matches_python_twins(tmp_path):
    """The port's own build of the C++ runtime: the MSVC stream and the
    v5 disk galaxy bit-identical to the numpy versions, and a dump
    written and parsed back."""
    assert tnative.available(), tnative.status()
    assert "available" in tnative.status()
    np.testing.assert_array_equal(tnative.msvc_rand(42, 100_000),
                                  tinit.msvc_rand_sequence(42, 100_000))
    np.testing.assert_array_equal(tnative.msvc_rand(2**32 + 5, 10),
                                  tinit.msvc_rand_sequence(5, 10))
    pos, vel, mass = tnative.disk_galaxy_ic(42, 2000, 0.5)
    ref = tinit.disk_galaxy_msvc(2000, 42, 0.5, device="cpu")
    # float32 sin/cos of the C library and of numpy may differ in the
    # last bit; the draws themselves are bit-exact
    np.testing.assert_array_equal(mass, ref.mass.numpy())
    np.testing.assert_allclose(pos, ref.pos.numpy(), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(vel, ref.vel.numpy(), rtol=1e-6, atol=1e-5)
    data = np.arange(12, dtype=np.float64).reshape(4, 3) / 7.0
    p = str(tmp_path / "nat.txt")
    tnative.write_dump(p, "# hdr", data)
    np.testing.assert_allclose(tnative.load_dump(p, 10, 3), np.round(data, 6),
                               atol=1e-9)


def test_native_build_failure_is_reported(monkeypatch):
    """A failed build is not swallowed: every entry point raises the
    compiler's error and status() reports it."""
    def fail():
        raise RuntimeError("g++ failed on runtime.cc (1):\nboom")

    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_ERROR", None)
    monkeypatch.setattr(tnative._build, "build", fail)
    assert not tnative.available()
    assert "boom" in tnative.status()
    with pytest.raises(RuntimeError, match="boom"):
        tnative.msvc_rand(1, 3)


@pytest.mark.parametrize("preset", ["bh_legacy", "v5"])
def test_summary_cell_count_and_diagnostics_match_jax(preset):
    """Integer and boolean fields equal; means and energies within
    float32 rounding of the JAX package's."""
    n = 6000
    jc = jcfg.PRESETS[preset].replace(n=n, use_pallas=False)
    tc = tcfg.PRESETS[preset].replace(n=n, use_pallas=False)
    pos, vel, mass, acc = _arrays(n, seed=3)
    js = JState.create(pos, vel, mass, acc)
    ts = state_from_numpy(pos, vel, mass, acc, device="cpu")
    assert int(tmetrics.cell_count(ts, tc)) == int(jmetrics.cell_count(js, jc))
    dj = jmetrics.bh_diagnostics(js, jc)
    dt = tmetrics.bh_diagnostics(ts, tc)
    assert dt.keys() == dj.keys()
    for k, v in dj.items():
        assert type(dt[k]) is type(v), k
        if isinstance(v, float):
            assert dt[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert dt[k] == v, k
    sj, st = jmetrics.summary(js, jc), tmetrics.summary(ts, tc)
    assert st.keys() == sj.keys()
    for k in ("ke", "px", "py", "pz"):
        assert st[k] == pytest.approx(sj[k], rel=1e-5, abs=1e-2), k
    assert st["bbox_min"] == sj["bbox_min"] and st["bbox_max"] == sj["bbox_max"]
    assert st["pe"] == pytest.approx(sj["pe"], rel=1e-4)
    assert "pe" not in tmetrics.summary(ts, tc, with_pe=False)


@pytest.mark.parametrize("make", [
    lambda d: tinit.make_initial_state(tcfg.SimConfig(n=64), device=d),
    lambda d: tinit.disk_galaxy_msvc(64, device=d),
    lambda d: tinit.disk_galaxy_torch(64, device=d),
    lambda d: tinit.legacy_disk(64, device=d),
    lambda d: tinit.uniform_cube(64, device=d),
], ids=["make_initial_state", "disk_galaxy_msvc", "disk_galaxy_torch",
        "legacy_disk", "uniform_cube"])
def test_initial_conditions_default_to_cuda_and_raise_without_it(monkeypatch,
                                                                 make):
    """With device=None the state goes to CUDA, which raises here; "cpu"
    builds it on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make(None)
    assert make("cpu").pos.device.type == "cpu"
