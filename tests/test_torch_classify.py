"""The band classifier's CUDA wrapper (ops/cuda/classify.py) on the CPU:
CPU tensors take the plain classifier and launch nothing, the argument
block mirrors csrc/band_classify.cu's struct field for field, its checks
raise on a dtype, shape or layout the kernel does not take before any
launch, it allocates the plain version's shapes and dtypes, and under
the CPU stand-in of a CUDA graph (torch_graph_standin.replayed) a replay
counts one launch a band build.  The kernel itself is held bit for bit
against the plain version on the card by chip_smoke.py's [classify]."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import bbox, forces
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import build, classify, launch
from nbody_tpu_torch.tools import common

from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

CFG = PRESETS["v5_bench"].replace(n=3000, force_tile=128,
                                  check_overflow=False)
SOURCE = Path(build.LIBRARIES["band_classify"].source)


@pytest.fixture(scope="module")
def upstream():
    """(tgt_subs, ss, supers, cells) of a skinned build at CFG's IC."""
    state = tsim.Simulation(CFG, device="cpu").init_state()
    ps, ms, cs, _, _, _ = common.sorted_padded(state, CFG)
    drift = 0.5 * torch.rand(ps.shape[0], generator=torch.Generator()
                             .manual_seed(3))
    lo, size = bbox.bounding_cube(ps)
    cells = build_source_cells(cs, ps, ms, CFG.force_tile, CFG.g,
                               CFG.cell_capacity, lo, size,
                               drift_sorted=drift,
                               g2_factor=CFG.g2_cap_factor,
                               bits=CFG.morton_bits)
    supers = forces.make_supers(cells)
    tgt = forces.target_subspheres(ps, CFG.force_tile, drift=drift, codes=cs,
                                   bits=CFG.morton_bits)
    return tgt, forces.make_ss(supers, CFG), supers, cells


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def no_launch(monkeypatch):
    """Fails the test if a kernel library is loaded (a launch would
    follow)."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("skin", [0.0, 40.0])
def test_cpu_tensors_take_the_plain_classifier(upstream, use_pallas, skin,
                                               no_launch):
    cfg = CFG.replace(use_pallas=use_pallas)
    launch.reset()
    got = forces.cell_band_lists(*upstream, cfg, skin=skin)
    assert classify.LAUNCHES == {"band_classify": 0}
    assert _same(got, forces.cell_band_lists_torch(*upstream, cfg, skin=skin))
    assert int(got.near_cnt.sum()) > 0 and int(got.win_cnt.sum()) > 0


@pytest.mark.parametrize("skin", [0.0, 40.0])
def test_demand_is_the_longest_list_and_flags_fire_exactly_past_it(upstream,
                                                                  skin):
    """The plain classifier's demand (forces.BAND_DEMAND, the kernel's
    bit for bit on the card): at caps that hold every list, each list's
    and window row's longest live count.  At caps equal to the demand no
    flag is set and every array is the larger caps' cut to the new
    widths, bit for bit; a cap one below its demand sets that list's
    flag alone (the windows' the near flag) and reports the same
    demand."""
    d = torch.zeros(len(forces.BAND_DEMAND), dtype=torch.int32)
    want = forces.cell_band_lists_torch(*upstream, CFG, skin=skin, demand=d)
    assert not any(bool(want[i]) for i in range(13, 18))
    live = (want.ss_cnt, want.sup_cnt, want.mid_cnt, want.cmid_cnt,
            want.near_cnt, want.win_cnt)
    assert d.tolist() == [int(x.max()) for x in live]
    assert min(d.tolist()) > 0
    caps = dict(zip(("ss_cap", "sup_cap", "mid_cap", "cmid_cap", "near_cap",
                     "win_cap"), d.tolist()))
    fit = CFG.replace(**caps)
    d2 = torch.zeros_like(d)
    got = forces.cell_band_lists_torch(*upstream, fit, skin=skin, demand=d2)
    assert torch.equal(d2, d)
    assert not any(bool(got[i]) for i in range(13, 18))
    for f, g, w in zip(forces.CellBands._fields[:13], got, want):
        assert torch.equal(g, w[..., :g.shape[-1]]), f
    flag_of = dict(zip(forces.BAND_DEMAND, forces.CellBands._fields[13:]
                       + ("near_overflow",)))
    for (cap, v), name in zip(caps.items(), forces.BAND_DEMAND):
        d3 = torch.zeros_like(d)
        short = forces.cell_band_lists_torch(
            *upstream, fit.replace(**{cap: v - 1}), skin=skin, demand=d3)
        set_ = {f for f in forces.CellBands._fields[13:]
                if bool(getattr(short, f))}
        assert set_ == {flag_of[name]}, name
        assert int(d3[forces.BAND_DEMAND.index(name)]) == v, name


def _struct_fields():
    """(name, kind) of each field of the source's struct ClassifyArgs."""
    body = re.search(r"struct ClassifyArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind = ("ptr" if "*" in line else
                "int" if line.startswith("int ") else "float")
        names = line.split("*")[-1] if kind == "ptr" else line.split(" ", 1)[1]
        fields += [(n.strip(), kind) for n in names.split(",")]
    return fields


def test_argument_block_mirrors_the_kernel_struct():
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    got = [(n, kinds[t]) for n, t in classify.ClassifyArgs._fields_]
    assert got == _struct_fields()
    assert ctypes.sizeof(classify.ClassifyArgs) == 8 * 39 + 4 * 14


def test_kernel_args_allocate_the_plain_shapes(upstream, no_launch):
    """The outputs the kernel fills have the plain version's shapes and
    dtypes, and the block carries their pointers, the sizes and caps and
    half the skin."""
    args, bands = classify.kernel_args(*upstream, CFG, skin=40.0)
    want = forces.cell_band_lists_torch(*upstream, CFG, skin=40.0)
    for f, g, w in zip(forces.CellBands._fields, bands, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), f
    assert not any(bool(bands[i]) for i in range(13, 18))
    assert args.ss_idx == bands.ss_idx.data_ptr()
    assert args.win_mask == bands.win_mask.data_ptr()
    assert args.gkid_com == upstream[3].gchild_com.data_ptr()
    tgt, ss, supers, cells = upstream
    assert (args.tiles, args.n_ss, args.n_sup, args.g_cap) == (
        tgt.radius.shape[0] // 8, ss.gmass.shape[0], supers.gmass.shape[0],
        cells.gmass.shape[0])
    assert (args.win_cap, args.pieces) == (CFG.win_cap_eff, CFG.win_pieces)
    assert (args.half, args.soft, args.theta) == (20.0, 50.0, 0.5)


def _bad(upstream, kind):
    tgt, ss, supers, cells = upstream
    if kind == "dtype":
        cells = cells._replace(child_first=cells.child_first.to(torch.int32))
    elif kind == "shape":
        ss = ss._replace(diam=ss.diam[:-1])
    elif kind == "contiguity":
        tgt = tgt._replace(center=tgt.center.t().contiguous().t())
    elif kind == "nesting":
        supers = supers._replace(com=supers.com[:-8], diam=supers.diam[:-8],
                                 skin=supers.skin[:-8],
                                 gmass=supers.gmass[:-8])
    return tgt, ss, supers, cells


@pytest.mark.parametrize("kind, err, match", [
    ("dtype", TypeError, "child_first"),
    ("shape", ValueError, "ss diam"),
    ("contiguity", ValueError, "contiguous"),
    ("nesting", ValueError, "nest by 8"),
])
def test_kernel_args_raise_before_any_launch(upstream, kind, err, match,
                                             no_launch):
    with pytest.raises(err, match=match):
        classify.kernel_args(*_bad(upstream, kind), CFG)


def test_replayed_builds_count_one_launch_each(replayed):
    """Through the stand-in graphs the per-step rebuild and the adaptive
    runner count one classifier launch a band build, as eager runs
    count them, with the eager trajectories bit for bit."""
    cfg = CFG.replace(n=1000)
    st = tsim.Simulation(cfg, device="cpu").init_state()
    sim = tsim.Simulation(cfg, device="cpu")
    launch.reset()
    s2 = sim.step(sim.step(st))
    assert classify.LAUNCHES == {"band_classify": 2}
    assert _same(s2, tsim.step_barnes_hut(tsim.step_barnes_hut(st, cfg), cfg))

    cfg = cfg.replace(rebuild_every=8, hold_farmid=4)
    outs = {}
    for graphed in (False, True):
        launch.reset()
        outs[graphed] = tsim._run_adaptive({}, cfg, st, 12, graphed)
        assert classify.LAUNCHES["band_classify"] == outs[graphed][1] >= 2
    assert _same(outs[True][0], outs[False][0])
    assert outs[True][1] == outs[False][1]


def test_chip_smoke_checks_a_classifier_launch_a_build(replayed):
    """chip_smoke.py's launch checks pass on the stand-in runner's and
    cycles' counts (one classifier launch a rebuild, a rebuild graph and a
    cycle graph, none in an inner step) and fail on a count off by one."""
    import chip_smoke

    cfg = CFG.replace(n=1000, rebuild_every=8, hold_farmid=4)
    st = tsim.Simulation(cfg, device="cpu").init_state()
    sim = tsim.Simulation(cfg, device="cpu")
    sim.run_scan(st, 12)
    launch.reset()
    sim.run_scan(st, 12)
    counts = chip_smoke.main_launches()
    rebuilds = counts["band_classify"]
    assert rebuilds >= 2
    chip_smoke.check_runner_launches(counts, 12, rebuilds)
    with pytest.raises(RuntimeError, match="classifier launches"):
        chip_smoke.check_runner_launches(counts, 12, rebuilds + 1)
    per_graph = chip_smoke.loop_launches(*sim._loops.values())
    assert per_graph["rebuild"]["band_classify"] == 1
    chip_smoke.check_builds("runner", per_graph)
    for g, off in (("rebuild", -1), ("inner farmid", 1)):
        bad = dict(per_graph, **{g: dict(per_graph[g], band_classify=(
            per_graph[g]["band_classify"] + off))})
        with pytest.raises(RuntimeError, match="classifier"):
            chip_smoke.check_builds("runner", bad)

    cyc = tsim.Simulation(cfg.replace(adaptive_rebuild=False), device="cpu")
    cyc.run_scan(st, 12)
    (loop,) = cyc._cycles.values()
    per_graph = {f"cycle {n}": chip_smoke.graph_launches(g)
                 for n, g in loop._cycles.items()}
    assert {d["band_classify"] for d in per_graph.values()} == {1}
    chip_smoke.check_builds("cycles", per_graph)


def test_prof_classify_times_the_production_classifier():
    """prof_classify prints the production classifier's line beside the
    plain stages: on the CPU the plain version, with no launch."""
    from nbody_tpu_torch.tools import prof_classify

    cfg = prof_classify.make_config(2000)
    state = tsim.Simulation(cfg, device="cpu").init_state()
    r = prof_classify.stage_times(state, cfg, stages=("stage0",), iters=1)
    assert r["production"]["route"] == "plain"
    assert r["production"]["launches"] == 0
    assert r["production"]["ms"] > 0 and r["production"]["ops"] > 0
    assert "the production classifier" in prof_classify.report(r)


def test_a_count_registered_inside_a_capture_is_taken_back_out(monkeypatch):
    """A wrapper module first imported inside a graph's warm-up registers
    its count there (forces.cell_band_lists imports ops/cuda/classify.py
    at its first call): the warm-up's launches are taken back out of it
    and the capture's recorded, so a replay counts what it runs."""
    monkeypatch.setattr(launch, "_COUNTERS", list(launch._COUNTERS))
    with launch.uncounted():                     # warm-up and capture
        late = launch.counter("late")            # the lazy import
        late["late"] += 1                        # the warm-up's launch
        with launch.uncounted() as made:         # the capture
            late["late"] += 1
    assert late == {"late": 0}
    launch.add(made)                             # one replay
    assert late == {"late": 1}


def test_reset_and_counts_cover_every_registered_count(monkeypatch):
    """launch.reset zeroes the counts of every wrapper module, and
    launch.counts reads them all, a count registered later too."""
    from nbody_tpu_torch.ops.cuda import forces as kern

    monkeypatch.setattr(launch, "_COUNTERS", list(launch._COUNTERS))
    late = launch.counter("late")
    kern.LAUNCHES["near_span"] += 2
    classify.LAUNCHES["band_classify"] += 1
    late["late"] += 3
    got = launch.counts()
    assert got["near_span"] >= 2 and got["band_classify"] >= 1
    assert got["late"] == 3
    assert set(kern.LAUNCHES) | set(classify.LAUNCHES) <= set(got)
    launch.reset()
    assert set(launch.counts().values()) == {0}
    assert kern.LAUNCHES["near_span"] == classify.LAUNCHES[
        "band_classify"] == late["late"] == 0
