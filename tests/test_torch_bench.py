"""nbody_tpu_torch.bench, the port's benchmark line, on the CPU at small
sizes: its live-pair count against the root bench.py's `band_flops` on
the JAX package's bands from the same sorted inputs, its executed-pair
count against a brute count written from the CUDA kernels' loop bounds,
its one JSON line, its flags, its drift field and its failures."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from nbody_tpu.config import PRESETS as JPRESETS
from nbody_tpu.init import disk_galaxy_msvc
from nbody_tpu.models.simulation import sort_by_morton as jsort_by_morton
from nbody_tpu.ops import forces as jforces

from nbody_tpu_torch import bench
from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.convert import config_from_dict
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import forces as tforces
from nbody_tpu_torch.tools import common
from nbody_tpu_torch.utils import metrics

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 8192
# v5_bench's knobs but force_tile; K = R = 2 keeps a timed call short
SMALL = ["--n", str(N), "--tile", "128", "--k", "2", "--r", "2",
         "--frames", "2", "--drift-steps", "4", "--skip-selfcheck",
         "--device", "cpu"]


def _root_bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench as root_bench
    finally:
        sys.path.remove(str(REPO))
    return root_bench


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


# geometry: v5_bench at N bodies with these overrides
GEOMETRIES = {"t128": dict(force_tile=128), "t512_v5": {}}


def _t(x):
    a = np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def built(request):
    """One Morton-sorted, padded disk of N bodies and the JAX package's
    build_bands of it, as the JAX structures and as the port's (each
    array converted; the port's own build of these inputs parts from
    JAX's at a MAC tie at t128: one cmid child goes to near, as
    test_torch_tools_accuracy.py shows for another seed)."""
    jc = JPRESETS["v5_bench"].replace(n=N, use_pallas=False,
                                      check_overflow=False,
                                      **GEOMETRIES[request.param])
    tc = config_from_dict(dataclasses.asdict(jc))
    st = disk_galaxy_msvc(N)
    sc, perm, _, _ = jsort_by_morton(st.pos, jc)
    ps, ms, cs = jforces.pad_sorted(st.pos[perm], st.mass[perm], sc,
                                    jc.force_tile)
    _, jss, jbands, jtables = jax.jit(
        lambda p, m, c: jforces.build_bands(p, m, c, jc))(ps, ms, cs)
    bands = tforces.CellBands(*(torch.from_numpy(np.array(x))
                                for x in jbands))
    return dict(name=request.param, jc=jc, tc=tc, n_pad=ps.shape[0],
                jss=jss, jbands=jbands, ps=_t(ps), ms=_t(ms),
                ss=tforces.Supers(*(_t(x) for x in jss)), bands=bands,
                tables=tforces.TableSet(*(_t(x) for x in jtables)))


def test_live_pairs_match_the_root_bench_band_flops(built):
    """work's live pairs, summed over the three kernels, equal the root
    bench.py's useful flops / 18 on the JAX package's own bands: far
    n_pad x n_supers, the live table rows and the set near mask bits."""
    jc, n_pad = built["jc"], built["n_pad"]
    s_used = int(built["jss"].n_supers)
    _, useful, _ = _root_bench().band_flops(jc, built["jbands"], n_pad,
                                            s_used)
    w = bench.work(built["tc"], built["ps"], built["ss"], built["bands"],
                   built["tables"])
    assert useful % 18 == 0
    assert w["far_sweep"]["live"] == n_pad * s_used
    assert sum(v["live"] for v in w.values()) == useful // 18
    assert min(v["live"] for v in w.values()) > 0


def _popcount(x):
    return bin(int(x) & 0xFFFFFFFF).count("1")


def _active_threads(n, per_thread, blocks):
    """(block, thread) pairs whose first target lies below n."""
    return sum(1 for g in range(blocks) for x in range(128)
               if g * per_thread * 128 + x < n)


def brute_far(n, n_live, s_cap):
    """tile_sweeps.cu far_sweep_kernel: 2 targets a thread, the live
    list clamped to [0, s_cap] in chunks of 1024, each padded to 8."""
    live = max(0, min(n_live, s_cap))
    swept = 0
    for base in range(0, live, 1024):
        count = min(1024, live - base)
        swept += (count + 7) & ~7
    blocks = max(1, -(-n // 256))
    return 2 * _active_threads(n, 2, blocks) * swept


def _tile_threads(b):
    r = max(1, min(4, b // 128))
    return r, _active_threads(b, r, -(-b // (r * 128)))


def brute_table(b, near_cnt, row_cnt, near_cap, rows):
    """table_sweep_kernel: a tile's min(near_cnt, near_cap) anti rows and
    its rows from near_cap to min(row_cnt, rows), in batches of 128, each
    padded to 8."""
    r, threads = _tile_threads(b)
    pairs = 0
    for nc, rc in zip(near_cnt.tolist(), row_cnt.tolist()):
        n = min(nc, near_cap) + max(min(rc, rows) - near_cap, 0)
        for batch in range(-(-n // 128)):
            count = min(128, n - batch * 128)
            pairs += r * threads * ((count + 7) & ~7)
    return pairs


def brute_near(b, win_first, win_mask, win_cnt, n_src):
    """near_span_kernel: per tile, the first min(win_cnt, w_cap) windows
    one a round, each round's live lanes (mask bits below n_src) pushed
    into the ring, 128 swept whenever the ring holds 128, the rest padded
    to 8 at the end."""
    r, threads = _tile_threads(b)
    first, mask = win_first.tolist(), win_mask.tolist()
    pairs = lanes = 0
    for t, wc in enumerate(win_cnt.tolist()):
        cnt = min(wc, len(first[t]))
        head = tail = swept = 0
        for k in range(cnt):
            for w in range(4):
                bits = mask[t][w][k] & 0xFFFFFFFF
                room = n_src - first[t][k] - 32 * w
                if room < 32:
                    bits = 0 if room <= 0 else bits & ((1 << room) - 1)
                tail += _popcount(bits)
            if tail - head >= 128:
                swept += 128
                head += 128
        swept += (tail - head + 7) & ~7
        lanes += swept
        pairs += r * threads * swept
    return pairs, lanes


def _brute(tc, ps, ss, bands, tables, n_src):
    return {
        "far_sweep": brute_far(ps.shape[0], int(ss.n_supers),
                               ss.gmass.shape[0]),
        "table_sweep": brute_table(tc.force_tile, tables.near_cnt,
                                   tables.row_cnt, tc.near_cap,
                                   tables.tx.shape[1]),
        "near_span": brute_near(tc.force_tile, bands.win_first,
                                bands.win_mask, bands.win_cnt, n_src)[0],
    }


@pytest.mark.parametrize("case", ["build", "n_src_cut", "past_the_caps"])
def test_executed_pairs_match_the_kernel_loops(built, case):
    """work's executed pairs equal a count that walks the kernels' loops:
    on the build (and there at least the live pairs); with the near sources cut 300 rows short of the
    targets (the kernel clears lanes past n_src); with table counts past
    near_cap and past the table's width (the kernel clamps them)."""
    tc, ps, ss = built["tc"], built["ps"], built["ss"]
    bands, tables = built["bands"], built["tables"]
    n_src = ps.shape[0]
    if case == "n_src_cut":
        n_src -= 300
    if case == "past_the_caps":
        t = tables.near_cnt.shape[0]
        bump = torch.arange(t, dtype=torch.int32) % 3
        tables = tables._replace(
            near_cnt=tables.near_cnt + bump * tc.near_cap,
            row_cnt=tables.row_cnt + bump * tables.tx.shape[1])
    w = bench.work(tc, ps, ss, bands, tables, n_src=n_src)
    want = _brute(tc, ps, ss, bands, tables, n_src)
    assert {k: v["executed"] for k, v in w.items()} == want
    assert w["near_span"]["executed_lanes"] == brute_near(
        tc.force_tile, bands.win_first, bands.win_mask, bands.win_cnt,
        n_src)[1]
    if case == "build":
        for k, v in w.items():
            assert v["executed"] >= v["live"] > 0, k


@pytest.mark.parametrize("n,n_live,s_cap", [
    (1000, 7, 64), (8192, 0, 64), (8192, 1, 64), (8192, 1500, 2000),
    (8192, 3000, 2000), (257, -3, 16)])
def test_far_executed_pairs_at_edge_counts(n, n_live, s_cap):
    """The far sweep's count off the tile sizes: n off 256 (the last
    block part masked), a live count of 0, 1, past one 1024 chunk, past
    the capacity and negative."""
    assert bench.far_slots(n) * bench.far_swept(n_live, s_cap) == brute_far(
        n, n_live, s_cap)
    assert bench.far_slots(n) == 2 * _active_threads(n, 2, -(-n // 256))


def test_bounds_ms_reads_work_and_keeps_its_output(built):
    """chip_smoke.bounds_ms now reads bench.work; its output is the
    formula it had before (live pairs x 20 over 67 TFLOP/s against the
    bytes over 3.35 TB/s), and chip_smoke's constants are bench's."""
    cs = _chip_smoke()
    for name in ("PEAK_FP32", "PEAK_BYTES", "FLOPS_PER_PAIR", "BOUNDS",
                 "DRIFT_LIMIT", "DRIFT_CRITERION", "work", "kernel_calls"):
        assert getattr(cs, name) is getattr(bench, name), name
    tc, ps, ss = built["tc"], built["ps"], built["ss"]
    bands, tables = built["bands"], built["tables"]
    n, b = ps.shape[0], tc.force_tile
    rows = int((bands.near_cnt.to(torch.int64)
                + tables.row_cnt.to(torch.int64) - tc.near_cap).sum())
    lanes = int(sum(bin(int(x) & 0xFFFFFFFF).count("1")
                    for t in range(bands.win_cnt.shape[0])
                    for x in bands.win_mask[t, :, :int(bands.win_cnt[t])]
                    .flatten()))
    windows = int(bands.win_cnt.sum())
    for n_src in (n, n - 300):
        before = {
            "far_sweep": (n * int(ss.n_supers),
                          24 * n + 16 * int(ss.n_supers) + 4),
            "table_sweep": (b * rows, 24 * n + 16 * rows + 8 * (n // b)),
            "near_span": (b * lanes, 24 * n + 16 * n_src + 20 * windows
                          + 4 * (n // b)),
        }
        got = cs.bounds_ms(tc, ps, ss, bands, tables, n_src=n_src)
        for k, (pairs, nbytes) in before.items():
            t_ops, t_mem = 20 * pairs / 67e12, nbytes / 3.35e12
            assert got[k] == (1e3 * max(t_ops, t_mem),
                              "operations" if t_ops >= t_mem else "bytes",
                              pairs), k


def _root_bench_keys():
    """The keys of the root bench.py's JSON line, read from its source."""
    import re

    src = (REPO / "bench.py").read_text()
    keys = set(re.findall(r'extra\["(\w+)"\]', src))
    keys |= {"metric", "value", "unit", "vs_baseline"}
    for suffix in ("", "_t128"):
        keys |= {f"selfcheck_{k}{suffix}" for k in ("far", "mid", "near")}
    return keys


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    """(stdout, stderr) of one main() at the small config."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        # no --skip-selfcheck: on the CPU the selfcheck leaves its fields
        # out by itself
        assert bench.main([a for a in SMALL if a != "--skip-selfcheck"]) == 0
    return out.getvalue(), err.getvalue()


def test_prints_one_json_line_with_the_root_bench_keys(line):
    """Exactly one stdout line, JSON, with the root bench.py's keys but
    the selfcheck_* ones (no kernel on the CPU), plus value_spread and
    the run's device, refresh and rebuild counts; mfu is null (the
    H100's peak says nothing of a CPU run)."""
    out, err = line
    lines = out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    want = {k for k in _root_bench_keys() if not k.startswith("selfcheck")}
    assert want == {"metric", "value", "unit", "vs_baseline", "gflops",
                    "gflops_useful", "mfu", "near_lane_occupancy",
                    "overflow_bands", "overflow_cells",
                    "overflow_g2_graceful", "overflow", "drift",
                    "drift_steps", "value_hot", "value_avg_1k"}
    assert set(got) == want | {"value_spread", "drift_ok", "device",
                               "refreshes", "rebuilds"}
    assert got["metric"] == f"bh_steps_per_sec_{N}_theta0.5"
    assert got["unit"] == "steps/sec" and got["device"] == "cpu"
    assert got["value"] > 0 and got["vs_baseline"] == got["value"] / 10.0
    assert got["value_spread"] >= 0 and got["mfu"] is None
    assert got["gflops"] >= got["gflops_useful"] > 0
    assert 0 < got["near_lane_occupancy"] <= 1
    assert 1 <= got["refreshes"] <= 2 and got["rebuilds"] >= 1
    assert got["drift_steps"] == 4 and got["drift_ok"] is True
    assert "selfcheck: no kernel runs on the CPU" in err
    assert "[bench] bands: ss=" in err and "dispatched step" in err


def test_drift_field_is_drift_protocol_from_the_ic(line):
    """drift equals metrics.drift_protocol from the initial conditions
    (E0 at entry) in chunks of `frames`, on a fresh Simulation of the
    same config: the kilostep gate's protocol."""
    got = json.loads(line[0])
    args = bench.parse_args(SMALL)
    cfg, frames = bench.make_config(args, torch.device("cpu"))
    sim = Simulation(cfg, device="cpu")
    dp = metrics.drift_protocol(sim, sim.init_state(), n_steps=4,
                                chunk=frames)
    assert got["drift"] == dp["drift"]
    assert got["drift_steps"] == dp["drift_steps"] == 4


@pytest.mark.parametrize("phase,target", [
    ("drift", (metrics, "drift_protocol")),
    ("flops", (bench, "timed_structure")),
    ("phases", (bench, "phase_times")),
    ("sustained", (Simulation, "run_scan")),
])
def test_a_failing_phase_makes_main_raise(phase, target, monkeypatch,
                                          capsys):
    """No phase's failure is printed and passed over: main raises, and
    prints no JSON line."""
    def fail(*a, **kw):
        raise RuntimeError(f"{phase} failed")

    monkeypatch.setattr(*target, fail)
    argv = ["--n", "2048"] + SMALL[2:] + ["--phases"]
    with pytest.raises(RuntimeError, match=f"{phase} failed"):
        bench.main(argv)
    assert capsys.readouterr().out == ""


def test_drift_past_the_limit_raises(monkeypatch, capsys):
    real = metrics.drift_protocol

    def drifting(*a, **kw):
        return dict(real(*a, **kw), drift=bench.DRIFT_LIMIT)

    monkeypatch.setattr(metrics, "drift_protocol", drifting)
    with pytest.raises(RuntimeError, match="energy drift"):
        bench.main(["--n", "2048"] + SMALL[2:])
    assert capsys.readouterr().out == ""


def test_every_root_bench_knob_has_its_flag():
    """Each NBODY_BENCH_* environment knob the root bench.py reads is a
    flag: NBODY_BENCH_DRIFT_STEPS -> --drift-steps."""
    import re

    knobs = set(re.findall(r"NBODY_BENCH_(\w+)",
                           (REPO / "bench.py").read_text()))
    assert {"N", "FRAMES", "K", "TILE", "R", "SPAN", "CAPS", "OVER",
            "PHASES", "PRESET", "DRIFT_STEPS", "SKIP_DRIFT",
            "SKIP_SELFCHECK"} <= knobs
    flags = set(bench.parse_args([]).__dict__)
    for knob in knobs:
        assert knob.lower() in flags, knob


def test_config_flags_apply_as_the_root_bench_applies_them():
    """Flags override the preset; --caps takes bench.py's k:v syntax and
    --over k=v, both typed by tools.common.parse_overrides; frames round
    up to a multiple of K; defaults are the preset's."""
    dev = torch.device("cpu")
    cfg, frames = bench.make_config(bench.parse_args([]), dev)
    assert cfg == PRESETS["v5_bench"].replace(use_pallas=False)
    assert frames == 32
    args = bench.parse_args([
        "--preset", "bh_4m", "--n", "5000", "--k", "3", "--frames", "7",
        "--tile", "256", "--r", "1", "--span", "1",
        "--caps", "sup_cap:320,cmid_cap:768",
        "--over", "refresh_moments=1,skin_width_cap=0.5"])
    cfg, frames = bench.make_config(args, dev)
    assert frames == 9
    assert (cfg.n, cfg.rebuild_every, cfg.force_tile, cfg.hold_farmid,
            cfg.farmid_span_rebuilds, cfg.sup_cap, cfg.cmid_cap,
            cfg.refresh_moments, cfg.skin_width_cap, cfg.theta) == (
        5000, 3, 256, 1, True, 320, 768, True, 0.5, 0.5)
    assert cfg.mid_cap == PRESETS["bh_4m"].mid_cap
    with pytest.raises(ValueError, match="unknown SimConfig field"):
        bench.make_config(bench.parse_args(["--caps", "bogus:1"]), dev)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--n", "2048"])


def test_far_counter_counts_plain_far_sweeps_on_the_cpu():
    """On the CPU the refresh count is the plain far sweep's calls (the
    wrapper's LAUNCHES count kernels only), and the patch is undone."""
    plain = tforces.far_sweep_torch
    cfg = PRESETS["v5_bench"].replace(n=2048, force_tile=128,
                                      use_pallas=False)
    state = Simulation(cfg, device="cpu").init_state()
    ps, ms, cs, *_ = common.sorted_padded(state, cfg)
    _, ss, bands, tables = tforces.build_bands(ps, ms, cs, cfg)
    with bench.far_counter(torch.device("cpu")) as far:
        tforces.apply_farmid(ps, ss, tables, cfg)
        tforces.apply_farmid(ps, ss, tables, cfg.replace(use_pallas=True))
        assert far() == 2
    assert tforces.far_sweep_torch is plain


def test_bench_imports_neither_jax_nor_nbody_tpu_nor_the_root_bench():
    code = ("import sys, nbody_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m in ('jax', 'bench')\n"
            "       or m.startswith(('jax.', 'nbody_tpu.'))\n"
            "       or m == 'nbody_tpu']\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
