"""What the harness promises outside the numbers: no module of JAX or of
the JAX package is loaded, a cell made only of new files is found by
name, and a run without a card, or with nothing but the benchmark's own
files, fails and prints no result.  The test marked `chip` needs the card
and skips without one."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.tests import harness_copy

ROOT = harness_copy.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_jax_and_no_jax_package_in_a_run():
    mods = _loaded_after(
        "import runpy, sys\n"
        "sys.argv = ['run.py']\n"
        "runpy.run_path('benchmark/run.py', run_name='not_main')\n"
        "from benchmark import harness, calibrate\n"
        "from nbody_tpu_torch.models.simulation import Simulation\n"
        "from nbody_tpu_torch.tools import common\n"
        "from nbody_tpu_torch.ops import forces")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & FORBIDDEN
    # the port's name begins with the JAX package's and passes
    assert "nbody_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import benchmark.reference.check\n"
                         "import benchmark.reference.direct\n"
                         "import benchmark.work")
    assert not {m.split(".")[0] for m in mods} & (FORBIDDEN
                                                  | {"nbody_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nbody_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == [
        m for m in sorted(sys.modules) if m.split(".")[0] in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_a_cell_of_new_files_is_found_by_name(tmp_path):
    root = harness_copy.small(tmp_path)
    b = root / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(dict(
        json.loads((b / "configs" / "bh_100k_k1.json").read_text()),
        n=1500)))
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(dict(
        ic="plummer", ic_params={"scale_radius": 300.0}, segment_steps=4,
        frame_steps=2, trace_steps=4, check_frames=2, check_bodies=256)))
    (b / "limits" / "tiny.tiny_mix.json").write_text(json.dumps(
        {"dv_err_p50": 8.0}))
    (b / "layer_metrics" / "tiny.window_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.window_steps)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.tiny_mix", "config": "tiny",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("tiny.tiny_mix")
    spec["per_layer"].append({"name": "tiny.window_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "steps_per_s",
                              "workloads": ["tiny.tiny_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny.tiny_mix", root)
    assert [m["name"] for m in cell.per_layer] == ["tiny.window_steps"]
    assert "force_err_p50" not in [m["name"] for m in cell.end_to_end]
    got = harness.per_layer(cell, SimpleNamespace(window_steps=12))
    assert got == {"tiny.window_steps": {"value": 12.0, "unit": "steps"}}
    out = harness.run("tiny.tiny_mix", 2**31 + 1, 0.1, False,
                      device=torch.device("cpu"), root=root)
    assert out["correct"] is True and out["attempted"] >= 2
    assert set(out["metrics"]) == {"steps_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.fixture
def card():
    """The CUDA card, or a skip when there is none (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)


def _run_py(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bh_100k_k1.disk", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, env=env)


def test_without_a_card_the_run_fails_and_prints_nothing():
    done = _run_py(ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "no CUDA device" in done.stderr


def test_the_benchmarks_files_alone_fail_and_print_nothing(tmp_path):
    done = _run_py(harness_copy.copy(tmp_path))
    assert done.returncode != 0 and done.stdout.strip() == ""


@pytest.mark.chip
def test_a_short_run_on_the_card(card):
    done = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bh_100k_k1.disk", "--seed", "2147483999", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
