"""nbody_tpu_torch's multi-device path (parallel/shard.py on gloo ranks
on the CPU) against the port's single-device runners, mirroring every
case of tests/test_shard.py but the graft entry (whose counterpart is
chip_smoke.py) at its sizes, seeds and tolerances, and against
nbody_tpu's sharded runners and pieces on the conftest's 8-device mesh.

Each module-scoped fixture spawns ONE mesh (parallel/launch.spawn, its
own timeout) that runs every job of its mesh size; the tests read their
results."""

import concurrent.futures
import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.init import disk_galaxy_jax
from nbody_tpu.models.simulation import sort_by_morton as jsort_by_morton
from nbody_tpu.ops import forces as jforces
from nbody_tpu.parallel import shard as jsh

from nbody_tpu_torch.convert import config_from_dict, state_from_numpy
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.parallel import jobs, launch
from nbody_tpu_torch.parallel.shard import _SHARD_CELL_SKEW, _shard_cell_cap
from nbody_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

SPAWN_TIMEOUT = 150     # seconds for one mesh's whole job list
TOL = dict(rtol=1e-4, atol=1e-3)       # tests/test_shard.py's runner bound
STEP_TOL = dict(rtol=1e-5, atol=1e-4)  # and its step bound
BASE = dict(theta=0.5, force_tile=64, use_pallas=False, ic_rng="jax")
# the shipping-integrator tuples of tests/test_shard.py
SHIPPING = [(True, False, 0, False), (True, True, 0, False),
            (False, True, 0, False), (True, False, 2, False),
            (True, False, 1, True)]


def _cfgs(**kw):
    jc = JConfig(**kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _galaxy(n, seed):
    """disk_galaxy_jax(n, seed) as numpy (pos, vel, mass, acc)."""
    return tuple(np.asarray(x) for x in disk_galaxy_jax(n, seed=seed, g=0.5))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got.pos), _np(want.pos), **tol)
    np.testing.assert_allclose(_np(got.vel), _np(want.vel), **tol)


# --- the jobs of each mesh ---------------------------------------------------


def _adaptive_kw(d):
    return dict(n=64 * d * 4, rebuild_every=4, adaptive_rebuild=True,
                hold_farmid=2, **BASE)


def _shipping_kw(span, moments, mult, noss):
    return dict(n=64 * 2 * 4, rebuild_every=4, adaptive_rebuild=True,
                hold_farmid=2, farmid_span_rebuilds=span,
                refresh_moments=moments, span_age_mult=mult, no_ss=noss,
                **BASE)


OVERFLOW_KW = dict(n=64 * 2 * 4, theta=0.3, force_tile=64, use_pallas=False,
                   ic_rng="jax", rebuild_every=16, adaptive_rebuild=True,
                   near_cap=8, cmid_cap=16, check_overflow=False)


def _mesh_jobs(d):
    """{name: (job, kwargs)} of the mirrored cases at mesh size d."""
    out = {
        "step": ("sharded_step", dict(cfg=_cfgs(n=64 * d * 4, **BASE)[1],
                                      state=_galaxy(64 * d * 4, 0),
                                      n_steps=1)),
        "cycles": ("sharded_cycles", dict(
            cfg=_cfgs(n=64 * d * 4, rebuild_every=3, **BASE)[1],
            state=_galaxy(64 * d * 4, 2), n_cycles=2, k=3)),
        "adaptive": ("sharded_adaptive", dict(
            cfg=_cfgs(**_adaptive_kw(d))[1], state=_galaxy(64 * d * 4, 5),
            n_steps=10)),
    }
    if d == 2:
        for tup in SHIPPING:
            out[("shipping",) + tup] = ("sharded_adaptive", dict(
                cfg=_cfgs(**_shipping_kw(*tup))[1],
                state=_galaxy(64 * 2 * 4, 5), n_steps=10))
        out["overflow"] = ("sharded_adaptive", dict(
            cfg=_cfgs(**OVERFLOW_KW)[1], state=_galaxy(64 * 2 * 4, 6),
            n_steps=8))
        return out
    out["multi_step"] = ("sharded_step", dict(
        cfg=_cfgs(n=64 * 8 * 2, **BASE)[1], state=_galaxy(64 * 8 * 2, 1),
        n_steps=3))
    out["hold"] = ("sharded_cycles", dict(
        cfg=_cfgs(n=64 * 8 * 2, rebuild_every=4, hold_farmid=2, **BASE)[1],
        state=_galaxy(64 * 8 * 2, 4), n_cycles=1, k=4))
    out["pads"] = ("sharded_cycles", dict(cfg=_cfgs(n=1000, **BASE)[1],
                                          state=_galaxy(1000, 3), n_cycles=1,
                                          k=2))
    out["seam"] = ("near_paths", dict(
        cfg=_cfgs(n=64 * 8 * 16, theta=0.8, force_tile=64, use_pallas=False,
                  ic_rng="jax", near_halo_div=2)[1],
        state=_galaxy(64 * 8 * 16, 7)))
    out["halo"] = ("near_halo_windows", _halo_windows_case())
    x, perm_small, perm_big = _reslab_case()
    out["reslab_small"] = ("reslab", dict(x=x, perm=perm_small, h=8))
    out["reslab_big"] = ("reslab", dict(x=x, perm=perm_big, h=8))
    return out


def _halo_windows_case():
    """tests/test_shard.py's synthetic in-reach windows: D = 8, b = 64,
    m = 4b, near_halo_div 2, eight aligned windows per target block."""
    d, b = 8, 64
    m = 4 * b
    n = d * m
    _, cfg = _cfgs(n=n, theta=0.5, force_tile=b, use_pallas=False,
                   ic_rng="jax", near_halo_div=2)
    h = max(128, m // 2)
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 100
    mass = rng.uniform(1, 2, size=(n,)).astype(np.float32)
    t_per, w_cap = m // b, 8
    wf = np.zeros((d * t_per, w_cap), np.int32)
    wm = np.zeros((d * t_per, 4, w_cap), np.int32)
    for c in range(d):
        lo = max(0, c * m - h)
        hi = min(n, (c + 1) * m + h) - 128
        starts = rng.integers(lo // 128, hi // 128 + 1,
                              size=(t_per, w_cap)) * 128
        starts.sort(axis=1)
        wf[c * t_per:(c + 1) * t_per] = starts
        wm[c * t_per:(c + 1) * t_per] = rng.integers(
            1, 2**31, size=(t_per, 4, w_cap), dtype=np.int64).astype(np.int32)
    return dict(cfg=cfg, pos=pos, mass=mass, win_first=wf, win_mask=wm, h=h)


def _reslab_case():
    """tests/test_shard.py's re-slab inputs: D = 8, m = 32, h = 8; a
    within-halo drift permutation and a far shuffle."""
    n, h = 8 * 32, 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    drift = rng.integers(-h + 1, h - 1, size=n)
    perm_small = np.argsort(np.arange(n) + drift, kind="stable")
    perm_big = rng.permutation(n)
    return x, perm_small, perm_big


def _spawn(d, named):
    names = list(named)
    res = launch.spawn(jobs.run, d, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT,
                       args=([named[k] for k in names],))
    return {k: [res[r][i] for r in range(d)] for i, k in enumerate(names)}


@pytest.fixture(scope="module", autouse=True)
def meshes():
    """Both meshes' runs, started together (the parent's threads only
    wait on the ranks); the tests' JAX work overlaps them."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    runs = {d: pool.submit(_spawn, d, _mesh_jobs(d)) for d in (2, 8)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def mesh2(meshes):
    return meshes[2].result()


@pytest.fixture(scope="module")
def mesh8(meshes):
    return meshes[8].result()


def _mesh(d, mesh2, mesh8):
    return mesh2 if d == 2 else mesh8


def _tstate(arrays):
    return state_from_numpy(*arrays)


# --- no mesh needed, then the JAX work (overlapping the meshes' runs) ---


def test_sharded_rebuild_compute_is_o_n_over_d():
    """Per-rank rebuild compute shrinks with the mesh: the owned-cell
    capacity is ~cell_capacity/D (+skew) and the windowed build's input
    is m + 8b rows."""
    _, cfg = _cfgs(n=1_000_000, force_tile=512)
    cap1 = _shard_cell_cap(cfg, 1)
    cap8 = _shard_cell_cap(cfg, 8)
    assert cap1 == cfg.cell_capacity
    assert cap8 <= -(-cfg.cell_capacity * _SHARD_CELL_SKEW // (64 * 8)) * 64
    assert cap8 <= cfg.cell_capacity * _SHARD_CELL_SKEW // 8 + 64
    n_pad = -(-cfg.n // (8 * cfg.force_tile)) * (8 * cfg.force_tile)
    m = n_pad // 8
    assert m + 8 * cfg.force_tile < n_pad // 4
    assert cap8 == jsh._shard_cell_cap(JConfig(n=1_000_000, force_tile=512),
                                       8)


# --- against nbody_tpu's sharded runners and pieces --------------------------


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_adaptive_runner_matches_jax(eight_devices, meshes, n_dev):
    """The same state through JAX's make_sharded_adaptive_runner on the
    virtual mesh and the port's on gloo ranks: equal rebuild counts,
    pos and vel within tests/test_shard.py's bound."""
    jc, _ = _cfgs(**_adaptive_kw(n_dev))
    st = disk_galaxy_jax(jc.n, seed=5, g=jc.g)
    mesh = jsh.make_mesh(n_dev)
    run = jsh.make_sharded_adaptive_runner(jc, mesh, 10, return_stats=True)
    want, want_rb = run(jsh.shard_state(st, mesh))
    got, got_rb = meshes[n_dev].result()["adaptive"][0]
    assert got_rb == int(want_rb)
    _close(got, want, TOL)


SEAM_KW = dict(n=64 * 8 * 16, theta=0.8, force_tile=64, use_pallas=False,
               ic_rng="jax", near_halo_div=2)


@pytest.fixture(scope="module")
def seam_pieces(eight_devices, meshes):
    """The near-exchange pieces and the owner-computes cells of the
    octant-seam state (tests/test_shard.py:298's body) under JAX's
    shard_map, and the port's on 8 gloo ranks from the same per-rank
    inputs (JAX's bands and sorted arrays)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jc, tc = _cfgs(**SEAM_KW)
    d = 8
    state = disk_galaxy_jax(jc.n, seed=7, g=jc.g)
    mesh = jsh.make_mesh(d)
    rng = np.random.default_rng(11)
    drift_all = jnp.asarray(rng.uniform(0, 2, jc.n).astype(np.float32))

    def body(pos, mass):
        pos_g, mass_g = jsh._gather(pos), jsh._gather(mass)
        codes_s, perm, lo, size = jsort_by_morton(pos_g, jc)
        ps, ms, cs = jforces.pad_sorted(pos_g[perm], mass_g[perm], codes_s,
                                        jc.force_tile)
        _, _, bands, _, my_pos = jsh._classify_slab(ps, ms, cs, jc)
        m = my_pos.shape[0]
        h = jsh._near_halo_rows(m, jc)
        reach_ok = jsh._near_reach_ok(bands, m, h)
        fetch_ok, starts_srv, wf_remap = jsh._near_fetch_plan(bands, m, h, jc)
        me = jax.lax.axis_index(jsh.AXIS)
        my_mass = jax.lax.dynamic_slice_in_dim(ms, me * m, m, 0)
        reqs_g = jax.lax.all_gather(starts_srv, jsh.AXIS)
        drift = drift_all[perm]
        cells, codes_own = jsh._cells_sharded(cs, ps, ms, jc, lo, size,
                                              drift=drift)

        def rep(x):
            return jnp.broadcast_to(x, (1,) + jnp.shape(x))

        return (rep(reach_ok), rep(fetch_ok), starts_srv[None],
                wf_remap[None], bands.win_first[None], bands.win_cnt[None],
                jsh._halo_ext(my_pos, h)[None],
                jsh._halo_ext(my_mass, h)[None],
                jsh._fetch_windows(my_pos, reqs_g, m)[None],
                my_pos[None], my_mass[None], codes_own[None],
                rep(cs), rep(ps), rep(ms), rep(drift), rep(lo), rep(size),
                jax.tree_util.tree_map(rep, cells))

    fn = shard_map(body, mesh=mesh, in_specs=(P(jsh.AXIS), P(jsh.AXIS)),
                   out_specs=P(jsh.AXIS), check_vma=False)
    sharded = jsh.shard_state(state, mesh)
    out = jax.jit(fn)(sharded.pos, sharded.mass)
    jx = jax.tree_util.tree_map(np.asarray, out)
    (reach_ok, fetch_ok, starts_srv, wf_remap, win_first, win_cnt, halo,
     halo_mass, fetched, my_pos, my_mass, codes_own, cs, ps, ms, drift, lo,
     size, cells) = jx
    m = my_pos.shape[1]
    h = int(halo.shape[1] - m) // 2
    key = cs[0].astype(np.int64)
    key = (key[:, 0] << 32) | key[:, 1]
    per_rank = []
    for r in range(d):
        # the plan reads only the windows; the other lists are unused
        bands = tforces.CellBands(*([torch.zeros(1)] * 10),
                                  win_first=torch.from_numpy(win_first[r]),
                                  win_mask=torch.zeros(1),
                                  win_cnt=torch.from_numpy(win_cnt[r]),
                                  **{f: torch.zeros((), dtype=torch.bool)
                                     for f in tforces.CellBands._fields[13:]})
        per_rank.append(dict(bands=bands, x=my_pos[r], mass=my_mass[r], m=m,
                             h=h, codes=key, pos_s=ps[0], mass_s=ms[0],
                             drift=drift[0], lo=lo[0], size=size[0]))
    res = launch.spawn(jobs.run, d, backend="gloo", device="cpu",
                       timeout=SPAWN_TIMEOUT,
                       args=([("pieces", dict(cfg=tc, per_rank=per_rank))],))
    return jx, [r[0] for r in res]


def test_near_exchange_pieces_match_jax(seam_pieces):
    """_near_reach_ok, _near_fetch_plan (fetch_ok, starts_srv, wf_remap),
    _halo_ext and _fetch_windows on the same inputs are bit-equal to
    JAX's under shard_map."""
    jx, got = seam_pieces
    (reach_ok, fetch_ok, starts_srv, wf_remap, _, _, halo, halo_mass,
     fetched) = jx[:9]
    for r, g in enumerate(got):
        assert g["reach_ok"] == bool(reach_ok[r])
        assert g["fetch_ok"] == bool(fetch_ok[r])
        np.testing.assert_array_equal(g["starts_srv"].numpy(), starts_srv[r])
        np.testing.assert_array_equal(g["wf_remap"].numpy(), wf_remap[r])
        np.testing.assert_array_equal(g["halo"].numpy(), halo[r])
        np.testing.assert_array_equal(g["halo_mass"].numpy(), halo_mass[r])
        np.testing.assert_array_equal(g["fetched"].numpy(), fetched[r])


def test_stitch_cells_matches_jax(seam_pieces):
    """_cells_sharded (windowed build, bmax carry exchange, _stitch_cells)
    on every rank equals JAX's on the same sorted arrays: integer fields
    bit-equal over the whole capacity, geometry to float32 rounding,
    moments within the float32 prefix's tolerance."""
    jx, got = seam_pieces
    codes_own, ps, ms = jx[11], jx[13][0], jx[14][0]
    jcells = jx[18]
    key = codes_own.astype(np.int64)
    key = (key[..., 0] << 32) | key[..., 1]
    noise = 4 * 1.2e-7 * float(np.sum(0.5 * ms * np.abs(ps).max(axis=1)))
    # corners sum float32 terms at the box's scale, which XLA may
    # contract into FMAs: a few ulps of the box coordinates
    geom_atol = 4 * float(np.spacing(np.float32(np.abs(jx[16][0]).max()
                                                 + jx[17][0])))
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["codes_own"].numpy(), key[r])
        cells = g["cells"]
        for f in ("first", "count", "child_first", "child_count",
                  "gchild_complete", "n_cells", "n_child", "n_g2",
                  "overflow", "overflow_g2"):
            np.testing.assert_array_equal(
                getattr(cells, f).numpy(),
                getattr(jcells, f)[r].astype(getattr(cells, f).numpy().dtype),
                err_msg=f)
        for f in ("diam", "child_diam", "gchild_diam_max", "skin",
                  "child_skin", "lo", "hi"):
            np.testing.assert_allclose(getattr(cells, f).numpy(),
                                       getattr(jcells, f)[r], rtol=1e-6,
                                       atol=geom_atol, err_msg=f)
        gm = {f: getattr(jcells, f)[r] for f in ("gmass", "child_gmass",
                                                 "gchild_gmass")}
        for f, mf in (("com", "gmass"), ("child_com", "child_gmass"),
                      ("gchild_com", "gchild_gmass")):
            np.testing.assert_allclose(getattr(cells, mf).numpy(), gm[mf],
                                       rtol=1e-3, atol=1e-3, err_msg=mf)
            allow = 1e-2 + noise / np.maximum(gm[mf], 1e-6)
            err = np.abs(getattr(cells, f).numpy()
                         - getattr(jcells, f)[r]).max(axis=-1)
            err = np.where(gm[mf] > 1e-2, err, 0.0)
            assert np.all(err <= allow), f"{f}: excess {(err - allow).max()}"
    assert int(jcells.n_cells[0]) > 0
    assert not bool(jcells.overflow[0])


# --- mirrors of tests/test_shard.py ------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_step_matches_single_device(mesh2, mesh8, n_dev):
    got = _mesh(n_dev, mesh2, mesh8)["step"][0]
    _, cfg = _cfgs(n=64 * n_dev * 4, **BASE)
    want = tsim.step_barnes_hut(_tstate(_galaxy(cfg.n, 0)), cfg)
    _close(got, want, STEP_TOL)


def test_sharded_multi_step_stable(mesh8):
    got = mesh8["multi_step"][0]
    assert got.pos.shape == (64 * 8 * 2, 3)
    assert torch.isfinite(got.pos).all()


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_cycle_runner_matches_single_device(mesh2, mesh8, n_dev):
    """The config-5 path (slab classification, live-position exchange,
    band reuse) must match the single-device cycle runner."""
    got = _mesh(n_dev, mesh2, mesh8)["cycles"][0]
    _, cfg = _cfgs(n=64 * n_dev * 4, rebuild_every=3, **BASE)
    want = tsim.make_cycle_runner(cfg, 2, 3)(_tstate(_galaxy(cfg.n, 2)))
    _close(got, want, TOL)


def test_sharded_hold_farmid_matches_single_device(mesh8):
    got = mesh8["hold"][0]
    _, cfg = _cfgs(n=64 * 8 * 2, rebuild_every=4, hold_farmid=2, **BASE)
    want = tsim.make_cycle_runner(cfg, 1, 4)(_tstate(_galaxy(cfg.n, 4)))
    _close(got, want, TOL)


def test_sharded_runner_pads_arbitrary_n(mesh8):
    """n not divisible by D*force_tile works (massless padding)."""
    got = mesh8["pads"][0]
    state = _galaxy(1000, 3)
    assert got.pos.shape == (1000, 3)
    assert torch.isfinite(got.pos).all()
    np.testing.assert_array_equal(got.mass.numpy(), state[2])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_adaptive_runner_matches_single_device(mesh2, mesh8, n_dev):
    """The production runner: the same trajectory AND the same rebuild
    schedule as make_adaptive_runner (the horizon from the gathered
    magnitudes, k_env and the summed overflow feedback)."""
    got, got_rb = _mesh(n_dev, mesh2, mesh8)["adaptive"][0]
    _, cfg = _cfgs(**_adaptive_kw(n_dev))
    want, want_rb = tsim.make_adaptive_runner(cfg, 10, return_stats=True)(
        _tstate(_galaxy(cfg.n, 5)))
    assert got_rb == want_rb, (f"rebuild schedules diverged: sharded "
                               f"{got_rb} vs single-device {want_rb}")
    assert want_rb >= 2, "test must exercise >= 2 rebuilds"
    _close(got, want, TOL)


@pytest.mark.parametrize("span,moments,mult,noss", SHIPPING)
def test_sharded_adaptive_shipping_integrator_matches(mesh2, span, moments,
                                                      mult, noss):
    """farmid_span_rebuilds (the held far+mid rides _reslab), the
    horizon-tied hold, refresh_moments (_refresh_farmid_slab) and no_ss
    reproduce make_adaptive_runner's trajectory and schedule."""
    got, got_rb = mesh2[("shipping", span, moments, mult, noss)][0]
    _, cfg = _cfgs(**_shipping_kw(span, moments, mult, noss))
    want, want_rb = tsim.make_adaptive_runner(cfg, 10, return_stats=True)(
        _tstate(_galaxy(cfg.n, 5)))
    assert got_rb == want_rb
    _close(got, want, TOL)


def test_sharded_adaptive_overflow_feedback_matches(mesh2):
    """The envelope feedback fires identically when the band caps are
    too small: the sharded runner sums slab-local overflow flags."""
    got, got_rb = mesh2["overflow"][0]
    _, cfg = _cfgs(**OVERFLOW_KW)
    state = _tstate(_galaxy(cfg.n, 6))
    want, want_rb = tsim.make_adaptive_runner(cfg, 8, return_stats=True)(
        state)
    diag = tmetrics.bh_diagnostics(state, cfg)
    assert diag["near_overflow"] or diag["cmid_overflow"], (
        "test config must overflow a band cap to exercise the feedback")
    assert got_rb == want_rb
    np.testing.assert_allclose(got.pos.numpy(), want.pos.numpy(), **TOL)


def test_near_fetch_path_fires_on_octant_seam_state(mesh8):
    """At the disk's octant seam no contiguous halo reaches the core's
    near windows, the window fetch plan covers them, and the fetch-path
    near band is bitwise the all_gather path's."""
    res = mesh8["seam"]
    assert not res[0]["halo_ok"], (
        "octant-seam windows should exceed any contiguous halo here")
    assert res[0]["fetch_ok"], (
        "the window fetch plan must cover the production seam state")
    assert all(r["halo_ok"] == res[0]["halo_ok"]
               and r["fetch_ok"] == res[0]["fetch_ok"] for r in res)
    for r in res:
        np.testing.assert_array_equal(r["a_fast"].numpy(),
                                      r["a_slow"].numpy())


def test_near_halo_fast_path_matches_gather(mesh8):
    """For windows inside the halo, the halo path is a pure re-indexing
    of the all_gather path: bitwise-equal accelerations."""
    for a_fast, a_slow in mesh8["halo"]:
        np.testing.assert_array_equal(a_fast.numpy(), a_slow.numpy())


def test_reslab_halo_fast_path_and_fallback(mesh8):
    """Both re-slab paths give exactly rows perm of the old order: the
    halo path when the drift stays within the halo, the full gather
    otherwise."""
    x, perm_small, perm_big = _reslab_case()
    out, any_out = mesh8["reslab_small"][0]
    np.testing.assert_array_equal(out.numpy(), x[perm_small])
    assert not any_out, "within-halo drift must take the fixed-traffic path"
    out, any_out = mesh8["reslab_big"][0]
    np.testing.assert_array_equal(out.numpy(), x[perm_big])
    assert any_out, "out-of-halo drift must trip the full-gather fallback"


# --- the mesh, the launcher and the config's slab count ----------------------


def test_make_mesh_refuses_what_the_machine_cannot_serve(monkeypatch):
    """The caller names the backend; nccl without one GPU per rank, a
    CUDA mesh without a GPU, nccl on the CPU and an unknown backend
    raise, in the parent before any rank starts and in make_mesh."""
    from nbody_tpu_torch.parallel import comm

    with pytest.raises(ValueError, match="nccl takes CUDA tensors only"):
        comm.check_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="backend must be one of"):
        launch.spawn(jobs.run, 2, backend="mpi", device="cpu", timeout=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launch.spawn(jobs.run, 2, backend="gloo", device="cuda", timeout=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        comm.check_backend("nccl", "cuda", 8)
    assert comm.check_backend("gloo", "cuda", 8).type == "cuda"
    assert comm.check_backend("gloo", "cpu", 8).type == "cpu"
    with pytest.raises(RuntimeError, match="initialised process group"):
        comm.make_mesh(None, "gloo", "cpu")


def test_spawn_raises_with_the_failing_ranks_traceback():
    """A rank that raises makes spawn kill the ranks and raise with that
    rank's traceback; a config whose mesh_shape names another slab count
    is refused on the mesh."""
    _, cfg = _cfgs(n=64 * 2 * 4, mesh_shape=(8,), **BASE)
    with pytest.raises(RuntimeError, match="mesh_shape") as err:
        launch.spawn(jobs.run, 2, backend="gloo", device="cpu",
                     timeout=SPAWN_TIMEOUT, args=([("sharded_adaptive", dict(
                         cfg=cfg, state=_galaxy(cfg.n, 5), n_steps=1))],))
    assert re.match(r"rank [01] of 2 failed", str(err.value))
    assert "Traceback" in str(err.value)
