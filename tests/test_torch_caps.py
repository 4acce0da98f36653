"""Band caps that grow and never drop pairs (models/simulation.py), on the
CPU: the adaptive runner grows the caps a Plummer sphere in Henon units
demands and never sweeps an overflowed build, bit for bit the run that
starts at the grown caps, with forces that the float64 direct sum of
benchmark/reference/direct.py holds (and a run whose caps cannot grow
fails); the disk at the default caps grows nothing and captures its
graphs once; a band budget below the demand raises, naming the caps;
the per-step rebuild and the fixed-K cycles count their builds' flags
and raise at the frame's sync; the growth runs inside the span
nbody.caps.grow, inside nbody.rebuild."""

import pytest
import torch

from benchmark.reference.direct import accelerations
from nbody_tpu_torch.config import PRESETS, SimConfig
from nbody_tpu_torch.init import plummer_henon
from nbody_tpu_torch.models import simulation as tsim

from test_torch_tracing import _traced
from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# caps far below what the sphere demands (sup ~21, mid ~163, near ~900
# at 4,096 bodies in tiles of 128), and a cell capacity of 1 a tile
SMALL = dict(sup_cap=8, mid_cap=16, cmid_cap=16, near_cap=16, win_cap=8,
             cell_cap_factor=1, g2_cap_factor=1)
CFG = PRESETS["lonestar_bh"].replace(n=4096, force_tile=128, use_pallas=False,
                                     rebuild_every=8, check_overflow=False,
                                     **SMALL)
STEPS, FRAME = 16, 8
# The frames' forces against the float64 direct sum at the last step's
# positions: theta = 0.5 monopoles over skinned bands err by far less at
# this size (measured p99 0.0023%, largest 0.0072%); a pair dropped at a
# cap leaves its cell's coarse monopole, off by its whole term (caps that
# cannot grow: p50 ~30%, p99 ~900%).
FORCE_P99, FORCE_MAX = 5e-4, 5e-3


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _force_errors(state, cfg):
    """Relative force error quantiles (p99, max) of the state's last step
    against the direct sum at the positions that step started from."""
    src = state.pos.double() - state.vel.double() * cfg.dt
    want = accelerations(src, src, state.mass, cfg.g, cfg.softening)
    err = (state.acc.double() - want).norm(dim=1) / want.norm(dim=1)
    return float(torch.quantile(err, 0.99)), float(err.max())


def _run(cfg, ic):
    """STEPS steps of Simulation.run in frames of FRAME: (the end state,
    each frame's force errors, the Simulation)."""
    sim = tsim.Simulation(cfg, device="cpu")
    errs = []
    out = sim.run(ic, STEPS, lambda done, s: errs.append(_force_errors(s, cfg)),
                  callback_every=FRAME)
    return out, errs, sim


@pytest.fixture(scope="module")
def sphere():
    ic = plummer_henon(CFG.n, seed=7, device="cpu")
    swept = []
    real = tsim._AdaptiveLoop._inner

    def inner(self, refresh):
        cells, _, bands, _, _ = self.built
        swept.append(bool(tsim.build_flags(cells, bands).any()))
        return real(self, refresh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsim._AdaptiveLoop, "_inner", inner)
        out, errs, sim = _run(CFG, ic)
    (loop,) = sim._loops.values()
    return dict(ic=ic, out=out, errs=errs, counters=sim.counters(),
                grown=loop.cfg, swept=swept)


def test_caps_grow_and_no_overflowed_build_is_swept(sphere):
    c = sphere["counters"]
    assert c["cap_growths"] >= 1 and c["builds_redone"] >= 1
    assert c["overflowed_builds"] == c["builds_redone"]
    assert c["builds"] == c["rebuilds"] + c["builds_redone"]
    assert len(sphere["swept"]) == STEPS and not any(sphere["swept"])
    for k, v in c["caps"].items():
        assert v >= c["demand_max"][k], k
    grown = sphere["grown"]
    for k in ("sup_cap", "mid_cap", "near_cap", "cell_cap_factor"):
        assert getattr(grown, k) > getattr(CFG, k), k


def test_the_run_equals_one_started_at_the_grown_caps(sphere):
    out, _, sim = _run(sphere["grown"], sphere["ic"])
    assert sim.counters()["cap_growths"] == 0
    assert _same(out, sphere["out"])


def test_frames_hold_the_direct_sum_and_pinned_caps_do_not(sphere,
                                                          monkeypatch):
    assert len(sphere["errs"]) == STEPS // FRAME
    for p99, worst in sphere["errs"]:
        assert p99 < FORCE_P99 and worst < FORCE_MAX

    def pinned(self):
        """A build swept as built, as before caps could grow."""
        s_valid, _, _ = self._build_once()
        self.k_env.fill_(tsim.next_envelope(s_valid, self.cfg))
        return s_valid

    monkeypatch.setattr(tsim._AdaptiveLoop, "_build", pinned)
    _, errs, sim = _run(CFG, sphere["ic"])
    assert sim.counters()["overflowed_builds"] == sim.n_rebuilds
    assert all(p99 > FORCE_P99 for p99, _ in errs)


def test_disk_at_default_caps_grows_nothing_and_captures_once(replayed):
    cfg = PRESETS["v5"].replace(n=3000, check_overflow=False)
    sim = tsim.Simulation(cfg, device="cpu")
    ic = sim.init_state()
    sim.run(ic, 8, lambda *_: None, callback_every=4)
    (loop,) = sim._loops.values()
    graphs = [loop._rebuild_graph, *loop._steps.values()]
    captured = [g.graph for g in graphs]
    sim.run(ic, 8, lambda *_: None, callback_every=4)
    c = sim.counters()
    assert c["cap_growths"] == c["builds_redone"] == 0
    assert c["overflowed_builds"] == 0
    assert loop.cfg is cfg
    assert [loop._rebuild_graph, *loop._steps.values()] == graphs
    assert [g.graph for g in graphs] == captured
    assert loop._rebuild_graph.graph is not None


def test_a_budget_below_the_demand_raises_naming_the_caps():
    ic = plummer_henon(CFG.n, seed=7, device="cpu")
    cfg = CFG.replace(band_budget_gib=1.05 * CFG.band_bytes / 2**30)
    with pytest.raises(RuntimeError, match=r"band_budget_gib.*near=\d+"):
        tsim.Simulation(cfg, device="cpu").run(ic, 2)


def test_grown_config_rounds_up_and_never_shrinks():
    cfg = SimConfig(n=10_000, force_tile=128)
    flags = [0, 1, 0, 0, 1, 1, 0]
    demand = [3, 300, 10, 10, 700, 900, 5000, 100]
    got = tsim.grown_config(cfg, flags, demand)
    # each to the power of two at or above its demand
    assert (got.sup_cap, got.near_cap, got.win_cap) == (512, 1024, 1024)
    assert got.mid_cap == cfg.mid_cap and got.cmid_cap == cfg.cmid_cap
    assert got.cell_capacity >= 8192
    assert tsim.caps_in_force(got)["g2"] >= 100
    with pytest.raises(RuntimeError, match="no cap to grow"):
        tsim.grown_config(cfg, [0, 0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 10, 10,
                                                       10, 10])


@pytest.mark.parametrize("path", ["per_step", "cycles"])
def test_other_paths_count_flags_and_raise_at_the_frame_sync(path):
    """The per-step rebuild and the fixed-K cycles keep their caps: their
    builds' flags are counted, and Simulation.run raises at the frame's
    sync with the demanded caps; run_scan alone does not read them."""
    cfg = CFG.replace(n=2048, rebuild_every=1 if path == "per_step" else 4,
                      adaptive_rebuild=path != "cycles", hold_farmid=1)
    ic = plummer_henon(cfg.n, seed=3, device="cpu")
    sim = tsim.Simulation(cfg, device="cpu")
    sim.run_scan(ic, 4)
    c = sim.counters()
    builds = c["step_builds"] if path == "per_step" else c["builds"]
    assert builds == (4 if path == "per_step" else 1)
    assert c["overflowed_builds"] == builds
    assert c["demand_max"]["near"] > cfg.near_cap
    with pytest.raises(RuntimeError, match=r"dropped pairs.*'near': \d+"):
        sim.run(ic, 4, lambda *_: None, callback_every=2)
    # the same caps on the disk, which fit them, read nothing amiss
    ok = tsim.Simulation(PRESETS["v5"].replace(
        n=2048, force_tile=128, use_pallas=False, check_overflow=False,
        rebuild_every=cfg.rebuild_every, adaptive_rebuild=cfg.adaptive_rebuild,
        hold_farmid=1), device="cpu")
    ok.run(ok.init_state(), 4, lambda *_: None, callback_every=2)
    assert ok.counters()["overflowed_builds"] == 0


def test_growth_runs_inside_its_span(replayed, tmp_path):
    """nbody.caps.grow lies inside the nbody.rebuild of the build that
    overflowed, once, and holds the redone builds' graph launches and
    horizon reads; a rebuild that grows nothing has no such span."""
    ic = plummer_henon(2048, seed=5, device="cpu")
    cfg = CFG.replace(n=2048, rebuild_every=4, use_pallas=True)
    sim = tsim.Simulation(cfg, device="cpu")
    _, spans = _traced(tmp_path, lambda: sim.run_scan(ic, 3))
    grow = [sp for sp in spans if sp[0] == "nbody.caps.grow"]
    assert len(grow) == 1 and grow[0][3] == "nbody.rebuild"
    redone = sim.counters()["builds_redone"]
    assert redone >= 1
    for name in ("nbody.graph.rebuild", "nbody.rebuild.horizon_read"):
        inside = [sp for sp in spans if sp[0] == name
                  and grow[0][1] <= sp[1] and sp[2] <= grow[0][2]]
        assert len(inside) == redone, name
        assert sum(sp[0] == name for sp in spans) == redone + sim.n_rebuilds
