"""nbody_tpu_torch.ops.panel and tools.prof_mxu against
tools/_prof_mxu.py: the three plain panels against the JAX tool's panels,
the plain sweep against the tool's Pallas sweep (interpret mode on the CPU), the kernel wrapper's CPU
dispatch and the entry point."""

import functools
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu_torch.ops.cuda import panel as kern
from nbody_tpu_torch.ops import panel
from nbody_tpu_torch.tools import prof_mxu

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jtool():
    """tools/_prof_mxu.py, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        "_prof_mxu", os.path.join(REPO, "tools", "_prof_mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(t, g, seed):
    rng = np.random.default_rng(seed)
    pos3 = rng.uniform(-1700, 1700, (t, panel.B, 3)).astype(np.float32)
    gx, gy, gz = (rng.uniform(-1700, 1700, g).astype(np.float32)
                  for _ in range(3))
    gm = rng.uniform(1, 7, g).astype(np.float32)
    return pos3, gx, gy, gz, gm


def _rel_to_scale(got, want, variant, inputs):
    """max over targets of |got - want| / the variant's term scale."""
    scale = panel.term_scale(variant, *(torch.from_numpy(x)
                                           for x in inputs)).numpy()
    return float((np.linalg.norm(got - want, axis=-1) / scale).max())


def test_constants_match(jtool):
    assert (panel.B, panel.LC, panel.SOFT) == (jtool.B, jtool.LC,
                                                        jtool.SOFT)


@pytest.mark.parametrize("variant", panel.VARIANTS)
def test_plain_panels_match_jax_panels(jtool, variant):
    pos3, gx, gy, gz, gm = _inputs(1, panel.LC, seed=1)
    want = getattr(jtool, f"_panel_{variant}")(
        jnp.asarray(pos3[0]), *(jnp.asarray(q).reshape(1, -1)
                                for q in (gx, gy, gz, gm)))
    got = panel.PANELS[variant](
        torch.from_numpy(pos3[0]), *(torch.from_numpy(q)
                                     for q in (gx, gy, gz, gm)))
    assert got.shape == (panel.B, 3)
    rel = _rel_to_scale(got.numpy()[None], np.asarray(want)[None], variant,
                        (pos3, gx, gy, gz, gm))
    assert rel < 1e-6, rel


@pytest.mark.parametrize("variant", panel.VARIANTS)
def test_plain_sweep_matches_pallas_sweep(jtool, variant, monkeypatch):
    """The Pallas kernel in interpret mode at t = 2 tiles, g = 2048."""
    monkeypatch.setattr(jtool.pl, "pallas_call", functools.partial(
        jtool.pl.pallas_call, interpret=True))
    inputs = _inputs(2, 2 * panel.LC, seed=2)
    want = jtool.sweep(getattr(jtool, f"_panel_{variant}"),
                       *(jnp.asarray(x) for x in inputs))
    got = panel.sweep(panel.PANELS[variant],
                         *(torch.from_numpy(x) for x in inputs))
    assert got.shape == (2, panel.B, 3)
    assert _rel_to_scale(got.numpy(), np.asarray(want), variant,
                         inputs) < 1e-6


def test_term_scale_bounds_every_sum():
    """|sum of terms| <= sum of |terms|: each variant's output (and, for
    the identity variants, each of its two sums) is within its scale."""
    inputs = [torch.from_numpy(x) for x in _inputs(3, panel.LC, seed=3)]
    for variant in panel.VARIANTS:
        out = panel.sweep(panel.PANELS[variant], *inputs)
        scale = panel.term_scale(variant, *inputs)
        assert scale.shape == out.shape[:2]
        assert bool((out.norm(dim=-1) <= scale * (1 + 1e-5)).all())


def test_wrapper_on_cpu_takes_the_plain_sweep():
    inputs = [torch.from_numpy(x) for x in _inputs(2, panel.LC, seed=4)]
    before = dict(kern.LAUNCHES)
    for variant in panel.VARIANTS:
        got = kern.sweep(variant, *inputs)
        want = panel.sweep(panel.PANELS[variant], *inputs)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kern.LAUNCHES == before           # no kernel launched on the CPU


def test_wrapper_rejects_bad_arguments():
    inputs = [torch.from_numpy(x) for x in _inputs(1, panel.LC, seed=5)]
    with pytest.raises(ValueError, match="variant"):
        kern.sweep("tf32", *inputs)
    meta = torch.empty(inputs[0].shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kern.sweep("vpu", meta, *inputs[1:])
    with pytest.raises(ValueError, match="multiple"):
        panel.sweep(panel.panel_vpu, inputs[0],
                       *(q[:100] for q in inputs[1:]))


def test_entry_point(monkeypatch, capsys):
    """--device cpu runs the plain versions and prints the JAX tool's
    differences; without a card the default device fails."""
    assert prof_mxu.main(["--device", "cpu", "--targets", "512",
                          "--sources", "1024"]) == 0
    out = capsys.readouterr().out
    assert "max rel diff vpu-vs-mxu:" in out
    assert "max rel diff vpu-vs-mxu_c:" in out
    res = prof_mxu.run(512, 1024, device="cpu", log=lambda m: None)
    assert res["ms"] == {v: None for v in panel.VARIANTS}
    assert set(res["diff"]) == {"mxu", "mxu_c"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof_mxu.main([]) == 1
