"""nbody_tpu_torch's command line on the CPU (--device cpu) against
nbody_tpu's: run (Step lines, JSON summary, dump and checkpoint), bench,
render and info, and the default device rule of `python -m
nbody_tpu_torch`."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu import cli as jcli

from nbody_tpu_torch import cli as tcli
from nbody_tpu_torch.utils import io as tio

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LINE = re.compile(r"^Step +(\d+)/(\d+) \| Time: +[\d.]+ ms \| "
                       r"KE: (\S+)(?: \| Cells: (\d+))?$")


def _run(main, capsys, argv):
    assert main(argv) == 0
    out = capsys.readouterr().out
    steps = [STEP_LINE.match(l).groups() for l in out.splitlines()
             if l.startswith("Step ")]
    summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
    return steps, summary, out


@pytest.mark.parametrize("method", ["direct", "barnes_hut_reference"])
def test_run_matches_the_jax_cli(tmp_path, capsys, method):
    """Same flags, same IC: Step lines (step counts and KE at %.4e, Time
    aside), summary keys and values, and the dumps within float32
    rounding of a few steps apart."""
    common = ["run", "--n", "300", "--steps", "6", "--log-every", "2",
              "--method", method, "--dt", "0.05"]
    jd, td = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    j_steps, j_sum, _ = _run(jcli.main, capsys, common + ["--dump", jd])
    t_steps, t_sum, t_out = _run(tcli.main, capsys,
                                 common + ["--dump", td, "--device", "cpu"])
    assert [s[:2] for s in t_steps] == [s[:2] for s in j_steps] == [
        ("2", "6"), ("4", "6"), ("5", "6")]
    for (_, _, ke_t, cells_t), (_, _, ke_j, cells_j) in zip(t_steps, j_steps):
        assert float(ke_t) == pytest.approx(float(ke_j), rel=2e-4)
        assert (cells_t is None) == (cells_j is None)
    assert t_sum.keys() == j_sum.keys()
    for k in ("ke", "pe", "e_total"):
        assert t_sum[k] == pytest.approx(j_sum[k], rel=1e-4), k
    np.testing.assert_allclose(t_sum["bbox_min"], j_sum["bbox_min"],
                               rtol=1e-5)
    meta_t, rows_t = tio.load_dump(td)
    meta_j, rows_j = tio.load_dump(jd)
    assert meta_t == meta_j
    assert open(td).readlines()[:4] == open(jd).readlines()[:4]
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=2e-4)
    assert f"wrote {td}" in t_out


def test_run_writes_dump_checkpoint_and_telemetry(tmp_path, capsys):
    dump, ck = str(tmp_path / "out.txt"), str(tmp_path / "ck.npz")
    steps, summ, _ = _run(tcli.main, capsys, [
        "run", "--n", "1500", "--steps", "5", "--log-every", "2",
        "--diagnostics", "--dump", dump, "--checkpoint", ck,
        "--device", "cpu"])
    assert [s[0] for s in steps] == ["2", "4"]
    assert all(s[3] is not None and int(s[3]) > 0 for s in steps)   # Cells
    assert summ["structure"]["n_cells"] > 0
    assert not summ["structure"]["cell_overflow"]
    meta, rows = tio.load_dump(dump)
    assert meta == {"bodies": 1500.0, "theta": 0.5, "dt": 0.02}
    assert rows.shape == (1500, 6)
    st, step = tio.load_checkpoint(ck, device="cpu")
    assert step == 5
    np.testing.assert_allclose(rows[:, :3], st.pos.numpy(), atol=5e-7)
    np.testing.assert_allclose(rows[:, 3:], st.vel.numpy(), atol=5e-7)
    assert summ["ke"] == pytest.approx(
        0.5 * float((st.mass * (st.vel**2).sum(1)).sum()), rel=1e-6)


def test_bench_render_and_info(tmp_path, capsys):
    assert tcli.main(["bench", "--n", "1024", "--frames", "2", "--phases",
                      "--device", "cpu", "--trace",
                      str(tmp_path / "tr")]) == 0
    out = capsys.readouterr().out
    assert "Frame      | Time (ms)       | FPS" in out
    assert re.search(r"median [\d.]+ ms/step", out)
    phases = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert set(phases) == {"sort_ms", "groups_ms", "far_ms", "mid_ms",
                           "near_ms", "integrate_ms"}
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0

    frames = tmp_path / "frames"
    assert tcli.main(["render", "--n", "800", "--steps", "3", "--every", "2",
                      "--mode", "depth", "--out", str(frames),
                      "--device", "cpu"]) == 0
    assert sorted(os.listdir(frames)) == ["frame_00000.ppm",
                                          "frame_00002.ppm"]
    assert (frames / "frame_00000.ppm").read_bytes().startswith(
        b"P6 1280 720 255\n")

    assert tcli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "native runtime: available" in out
    assert "kernel library forces" in out


def test_run_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """Without --device the CLI asks for CUDA: in-process with CUDA
    hidden, and as `python -m nbody_tpu_torch`, which fails where no GPU
    is present and runs where one is."""
    has_gpu = torch.cuda.is_available()
    res = subprocess.run([sys.executable, "-m", "nbody_tpu_torch", "run",
                          "--n", "64", "--steps", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if has_gpu:
        assert res.returncode == 0, res.stderr
    else:
        assert res.returncode != 0 and "CUDA" in res.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["run", "--n", "64", "--steps", "1"])
