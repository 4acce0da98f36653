"""Every ported tool's command line: ``main([..., "--device", "cpu"])`` at
a tiny size runs to its end and prints the JAX tool's lines; without a
GPU the default device (CUDA) raises; the override and cap strings parse
as the JAX tools parse them."""

import importlib

import pytest
import torch

from nbody_tpu_torch.tools import common, prof_mkhot

torch.set_num_threads(2)

N = "600"


@pytest.fixture(scope="module")
def hot(tmp_path_factory):
    """A checkpoint from prof_mkhot's command line (n = 600, 2 steps)."""
    path = str(tmp_path_factory.mktemp("tools") / "hot.npz")
    assert prof_mkhot.main([N, "2", path, "--device", "cpu"]) == 0
    return path


# tool: (arguments before --device, a piece of the output)
RUNS = {
    "prof_mkhot": (lambda h, d: [N, "2", f"{d}/hot2.npz"], "[mkhot] wrote"),
    "prof_kilostep": (lambda h, d: [
        "16", "8", N, "--steps", "2", "--chunk", "2", "--log-every", "2",
        "--caps", "64,128,128,256", "--over", "force_tile=128",
        "--save", f"{d}/ks.npz"], "saved hot state ->"),
    "prof_fbias": (lambda h, d: ["", "theta=0.4", "--hot-state", h],
                   "[theta=0.4] P_err="),
    "prof_fbias_cpu": (lambda h, d: [N], "[{'no_ss': True}] rel_mean="),
    "prof_capdemand": (lambda h, d: ["0", N], "[hot live ] sup"),
    "prof_latestate": (lambda h, d: ["0", N], "K=32:"),
    "prof_tailtargets": (lambda h, d: [N], "non-fat targets near"),
    "prof_nearwin": (lambda h, d: ["0", N], "[skins ] far+mid:"),
    "prof_stale": (lambda h, d: ["0", N], "j=16 refresh"),
    "prof_skinerr": (lambda h, d: ["--hot-state", h], "K=16:"),
    "prof_crash1m": (lambda h, d: [N, "2", "1"], "[crash1m] survived"),
    "prof_hotrate": (lambda h, d: [h, "force_tile=128", "hold_farmid=2",
                                   "--ic"], "sustained IC:"),
    "prof_hotcfg": (lambda h, d: ["0.75", h], "sustained hot:"),
    "prof_rebuild": (lambda h, d: [N, "2", "force_tile=128"],
                     "FULL build_bands"),
    "prof_runner": (lambda h, d: [N, "4"], "fit total(s)"),
    "prof_cells": (lambda h, d: [N], "full_skin"),
    "prof_groups": (lambda h, d: [N], "band_lists"),
    "prof_classify": (lambda h, d: [N, "force_tile=128", "--hot-state", h],
                      "windows"),
    "prof_winmask": (lambda h, d: ["256", "200"], "outputs identical"),
    "prof_inner": (lambda h, d: [N, "2"], "full body (no rebuilds)"),
    "prof_cycle": (lambda h, d: [N, "4"], "stepped:"),
    "prof_cadence": (lambda h, d: ["16", "4", "2", "0.75", "--n", N,
                                   "--hot-state", h], "hot   :"),
    "prof_view": (lambda h, d: [N, "2"], "[pipelined] n=600"),
}


@pytest.mark.parametrize("tool", sorted(RUNS))
def test_tool_runs_on_the_cpu(tool, hot, tmp_path, capsys):
    args, marker = RUNS[tool]
    mod = importlib.import_module(f"nbody_tpu_torch.tools.{tool}")
    assert mod.main(args(hot, tmp_path) + ["--device", "cpu"]) == 0
    assert marker in capsys.readouterr().out


@pytest.mark.parametrize("tool", sorted(RUNS))
def test_tool_defaults_to_cuda_and_raises_without_it(tool, hot, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, _ = RUNS[tool]
    mod = importlib.import_module(f"nbody_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(args(hot, tmp_path))


def test_override_and_cap_strings_parse_as_the_jax_tools_do():
    assert common.parse_overrides("force_tile=512,refresh_moments=1,"
                                  "theta=0.4,no_ss=false") == dict(
        force_tile=512, refresh_moments=True, theta=0.4, no_ss=False)
    assert common.parse_overrides(["hold_farmid=8"]) == dict(hold_farmid=8)
    assert common.parse_overrides("") == {}
    with pytest.raises(ValueError, match="unknown SimConfig field"):
        common.parse_overrides("no_such_field=1")
    assert common.parse_caps("1,2,3,4") == dict(sup_cap=1, mid_cap=2,
                                                cmid_cap=3, near_cap=4)
    state, step = common.load_state("IC", n=300, device="cpu")
    assert (state.n, step) == (300, 0)
