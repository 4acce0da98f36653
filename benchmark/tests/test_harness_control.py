"""`correct` against its control and against the timed path broken
underneath.  Each cell's own limits (benchmark/limits/), on the CPU at a
size a test run holds (harness_copy.small): the unbroken run passes; the
bfloat16 control read at the run's frames fails; and with the chip's
look skipped, a run whose path is broken comes out not correct, once for
each fault the one-card cells can have: a step that returns its state
unchanged, a step that updates velocities but leaves positions where
they were or moves them by half of dt, half of the sources left out with
the rest's masses doubled, and an answer (a frame's state) altered where
it is produced."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import check
from benchmark.tests import harness_copy
from nbody_tpu_torch.models import simulation
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces, integrate
from nbody_tpu_torch.state import ParticleState

torch.set_num_threads(4)
CPU = torch.device("cpu")
CELLS = ("v5_bench_1m.disk", "bh_100k_k1.disk")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return harness_copy.small(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=2**31 + 17):
    return harness.run(cell, seed, 0.2, False, device=CPU, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    c = harness.load_cell(cell, root)
    cfg = harness.sim_config(c, CPU)
    sim = Simulation(cfg, device=CPU)
    start = harness.start_state(c, cfg, 23, CPU)
    win = harness.run_window(sim, start, c, 23, 0.1)
    ctl = harness.check_window(win, c, cfg, 23, CPU, control=True)
    ok, checks = check.judge(ctl["numbers"], c.limits)
    assert not ok, checks


def _halved(mass):
    """Half the sources left out, the rest's masses doubled."""
    keep = (torch.arange(mass.shape[-1], device=mass.device) % 2 == 0)
    return mass * keep.to(mass.dtype) * 2


def _unchanged(state, acc, cfg):
    return ParticleState(pos=state.pos, vel=state.vel, mass=state.mass,
                         acc=acc)


def _moved(scale):
    """Euler-Cromer with each step's displacement scaled by `scale`."""
    update = integrate.integrate

    def integrate_(state, acc, cfg):
        out = update(state, acc, cfg)
        return out._replace(pos=state.pos + scale * out.vel * cfg.dt)

    return integrate_


def _fault(monkeypatch, kind):
    if kind == "unchanged":
        monkeypatch.setattr(integrate, "integrate", _unchanged)
    elif kind == "unmoved":
        monkeypatch.setattr(integrate, "integrate", _moved(0.0))
    elif kind == "half_dt":
        monkeypatch.setattr(integrate, "integrate", _moved(0.5))
    elif kind == "half":
        build, near, grouped = (forces.build_bands, forces.apply_near,
                                forces.bh_forces_grouped)
        monkeypatch.setattr(forces, "build_bands",
                            lambda p, m, *a, **k: build(p, _halved(m), *a,
                                                        **k))
        monkeypatch.setattr(forces, "apply_near",
                            lambda t, s, m, *a, **k: near(t, s, _halved(m),
                                                          *a, **k))
        monkeypatch.setattr(forces, "bh_forces_grouped",
                            lambda p, m, *a, **k: grouped(p, _halved(m), *a,
                                                          **k))
    elif kind == "altered":
        run_scan = simulation.Simulation.run_scan

        def altered(self, state, n_steps):
            out = run_scan(self, state, n_steps)
            return out._replace(vel=out.vel * 1.01)

        monkeypatch.setattr(simulation.Simulation, "run_scan", altered)


@pytest.mark.parametrize("kind", ["unchanged", "unmoved", "half_dt", "half",
                                  "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(root, cell, kind, monkeypatch):
    _fault(monkeypatch, kind)
    out = _run(root, cell)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1
