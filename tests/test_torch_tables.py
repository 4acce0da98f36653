"""The band-table build's CUDA wrapper (ops/cuda/tables.py) on the CPU:
CPU tensors and use_pallas=False take the plain build and launch nothing,
the argument block mirrors csrc/band_tables.cu's struct field for field,
its checks raise on a dtype, shape or layout the kernel does not take
before any launch, it allocates the plain version's shapes and dtypes,
under the CPU stand-in of a CUDA graph (torch_graph_standin.replayed) a
replay counts one table build a band build and one a moment refresh, and
the plain table sweep reads only a tile's live rows.  The kernel itself
is held bit for bit against the plain build on the card by the tests
marked `chip` below (python -m pytest --noconftest -m chip
tests/test_torch_tables.py there) and by chip_smoke.py's [tables]."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.models import simulation as tsim
from nbody_tpu_torch.ops import bbox, forces
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.cuda import build, launch, tables
from nbody_tpu_torch.tools import common

from torch_graph_standin import replayed  # noqa: F401 (a fixture)

torch.set_num_threads(2)

CFG = PRESETS["v5_bench"].replace(n=3000, force_tile=128,
                                  check_overflow=False)
SOURCE = Path(build.LIBRARIES["band_tables"].source)


def _upstream(cfg, state, skin):
    """(cells, supers, ss, bands) of a build at `state`, with drift skins
    when `skin`."""
    ps, ms, cs, _, _, _ = common.sorted_padded(state, cfg)
    drift = None
    if skin:
        drift = skin * torch.rand(ps.shape[0], generator=torch.Generator()
                                  .manual_seed(3))
    lo, size = bbox.bounding_cube(ps)
    cells = build_source_cells(cs, ps, ms, cfg.force_tile, cfg.g,
                               cfg.cell_capacity, lo, size,
                               drift_sorted=drift,
                               g2_factor=cfg.g2_cap_factor,
                               bits=cfg.morton_bits)
    supers = forces.make_supers(cells)
    ss = forces.make_ss(supers, cfg)
    tgt = forces.target_subspheres(ps, cfg.force_tile, drift=drift, codes=cs,
                                   bits=cfg.morton_bits)
    bands = forces.cell_band_lists_torch(tgt, ss, supers, cells, cfg)
    return cells, supers, ss, bands, ps


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["bare", "skins"])
def upstream(request):
    state = tsim.Simulation(CFG, device="cpu").init_state()
    return _upstream(CFG, state, request.param)


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
def test_cpu_tensors_take_the_plain_build(upstream, use_pallas, no_launch):
    cfg = CFG.replace(use_pallas=use_pallas)
    cells, supers, ss, bands, _ = upstream
    launch.reset()
    got = forces.build_cell_tables(cells, supers, ss, bands, cfg)
    assert tables.LAUNCHES == {"table_build": 0}
    assert _same(got, forces.build_cell_tables_torch(cells, supers, ss,
                                                     bands))
    assert int(got.near_cnt.sum()) > 0
    assert int((got.row_cnt - cfg.near_cap).sum()) > 0


def _struct_fields():
    """(name, kind) of each field of the source's struct TablesArgs."""
    body = re.search(r"struct TablesArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind = "ptr" if "*" in line else "int"
        assert kind == "ptr" or line.startswith("int "), line
        names = line.split("*")[-1] if kind == "ptr" else line.split(" ", 1)[1]
        fields += [(n.strip(), kind) for n in names.split(",")]
    return fields


def test_argument_block_mirrors_the_kernel_struct():
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    got = [(n, kinds[t]) for n, t in tables.TablesArgs._fields_]
    assert got == _struct_fields()
    assert ctypes.sizeof(tables.TablesArgs) == 8 * 26 + 4 * 10


def test_kernel_args_allocate_the_plain_shapes(upstream, no_launch):
    """The planes and counts the kernel fills have the plain version's
    shapes and dtypes, each plane contiguous as the table sweep takes it,
    and the block carries their pointers, the levels' sizes, the lists'
    widths and the blocks a tile."""
    cells, supers, ss, bands, _ = upstream
    args, got = tables.kernel_args(cells, supers, ss, bands)
    want = forces.build_cell_tables_torch(cells, supers, ss, bands)
    for f, g, w in zip(forces.TableSet._fields, got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), f
        assert g.is_contiguous(), f
    assert args.tx == got.tx.data_ptr() and args.tm == got.tm.data_ptr()
    assert args.near_cnt_out == got.near_cnt.data_ptr()
    assert args.gkid_com == cells.gchild_com.data_ptr()
    assert args.near_idx == bands.near_idx.data_ptr()
    assert (args.tiles, args.n_ss, args.n_sup, args.g_cap) == (
        bands.near_idx.shape[0], ss.gmass.shape[0], supers.gmass.shape[0],
        cells.gmass.shape[0])
    assert (args.ss_cap, args.sup_cap, args.mid_cap, args.cmid_cap,
            args.near_cap) == (CFG.ss_cap, CFG.sup_cap, CFG.mid_cap,
                               CFG.cmid_cap, CFG.near_cap)
    rows = want.tx.shape[1]
    assert args.splits == tables.splits(rows) >= 1


def test_splits_spread_wide_rows_and_stay_bounded():
    assert tables.splits(1) == 1
    assert tables.splits(tables.ROWS_PER_BLOCK) == 1
    assert tables.splits(tables.ROWS_PER_BLOCK + 1) == 2
    assert tables.splits(65_536 + 9 * 13_504) == 46
    assert tables.splits(tables.MAX_SPLITS * tables.ROWS_PER_BLOCK
                         + 1) == tables.MAX_SPLITS


def _bad(upstream, kind):
    cells, supers, ss, bands, _ = upstream
    if kind == "dtype":
        bands = bands._replace(near_idx=bands.near_idx.to(torch.int64))
    elif kind == "shape":
        ss = ss._replace(gmass=ss.gmass[:-1])
    elif kind == "contiguity":
        cells = cells._replace(com=cells.com.t().contiguous().t())
    elif kind == "counts":
        bands = bands._replace(mid_cnt=bands.mid_cnt[:-1])
    elif kind == "nesting":
        supers = supers._replace(com=supers.com[:-8],
                                 gmass=supers.gmass[:-8])
    return cells, supers, ss, bands


@pytest.mark.parametrize("kind, err, match", [
    ("dtype", TypeError, "near_idx"),
    ("shape", ValueError, "ss gmass"),
    ("contiguity", ValueError, "contiguous"),
    ("counts", ValueError, "mid_cnt"),
    ("nesting", ValueError, "nest by 8"),
])
def test_kernel_args_raise_before_any_launch(upstream, kind, err, match,
                                             no_launch):
    with pytest.raises(err, match=match):
        tables.kernel_args(*_bad(upstream, kind))


def test_plain_sweep_reads_only_live_rows(upstream):
    """table_sweep_torch gives the same forces, bit for bit, when every
    row outside the live ranges holds NaN (as the kernel may leave it) as
    when it holds zero (as the plain build writes it)."""
    cells, supers, ss, bands, ps = upstream
    want = forces.build_cell_tables_torch(cells, supers, ss, bands)
    live = forces.live_rows(want.near_cnt, want.row_cnt, CFG.near_cap,
                            want.tx.shape[1])
    assert 0 < int(live.sum()) < live.numel()
    dead = forces.TableSet(*(torch.where(live, p, float("nan"))
                             for p in want[:4]), *want[4:])
    a = forces.table_sweep_torch(ps, want, CFG)
    b = forces.table_sweep_torch(ps, dead, CFG)
    assert torch.isfinite(a).all()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert tables.live_diff(dead, want, CFG.near_cap) == []


def test_live_diff_sees_a_live_bit_and_not_a_dead_row(upstream):
    cells, supers, ss, bands, _ = upstream
    want = forces.build_cell_tables_torch(cells, supers, ss, bands)
    live = forces.live_rows(want.near_cnt, want.row_cnt, CFG.near_cap,
                            want.tx.shape[1])
    t, r = live.nonzero()[-1].tolist()
    got = forces.TableSet(*(p.clone() for p in want))
    got.tz[t, r] = -got.tz[t, r] if got.tz[t, r] != 0 else -0.0
    assert tables.live_diff(got, want, CFG.near_cap) == ["tz"]
    t, r = (~live).nonzero()[0].tolist()
    got = forces.TableSet(*(p.clone() for p in want))
    got.tm[t, r] = 1.0
    got.row_cnt[0] += 9
    assert tables.live_diff(got, want, CFG.near_cap) == ["row_cnt"]


def test_replayed_builds_count_one_table_build_each(replayed):
    """Through the stand-in graphs the per-step rebuild and the adaptive
    runner count one table build a band build, as eager runs count them,
    and a refresh_moments runner one more a moment refresh (its refreshed
    inner graph builds tables, no other inner graph does), with the eager
    trajectories bit for bit."""
    import chip_smoke

    cfg = CFG.replace(n=1000)
    st = tsim.Simulation(cfg, device="cpu").init_state()
    sim = tsim.Simulation(cfg, device="cpu")
    launch.reset()
    s2 = sim.step(sim.step(st))
    assert tables.LAUNCHES == {"table_build": 2}
    assert _same(s2, tsim.step_barnes_hut(tsim.step_barnes_hut(st, cfg), cfg))

    for extra, more in ((dict(rebuild_every=8, hold_farmid=4), False),
                        (dict(rebuild_every=8, hold_farmid=2,
                              refresh_moments=True,
                              farmid_span_rebuilds=False), True)):
        c = cfg.replace(**extra)
        outs = {}
        for graphed in (False, True):
            launch.reset()
            outs[graphed] = tsim._run_adaptive({}, c, st, 12, graphed)
            got = launch.counts()
            assert got["band_classify"] == outs[graphed][1] >= 2
            assert (got["table_build"] > got["band_classify"]) == more
            outs[graphed] += (got,)
        assert _same(outs[True][0], outs[False][0])
        assert outs[True][1:] == outs[False][1:]
        sim = tsim.Simulation(c, device="cpu")
        sim.run_scan(st, 12)
        per_graph = chip_smoke.loop_launches(*sim._loops.values())
        assert per_graph["rebuild"]["table_build"] == 1
        assert ("inner refreshed" in per_graph) == more
        chip_smoke.check_builds("runner", per_graph)


def test_chip_smoke_checks_a_table_build_a_build(replayed):
    """chip_smoke.py's launch checks pass on the stand-in runner's counts
    (one table build a rebuild and a rebuild graph, none in an inner step
    without a moment refresh) and fail on a table count off by one."""
    import chip_smoke

    cfg = CFG.replace(n=1000, rebuild_every=8, hold_farmid=4)
    st = tsim.Simulation(cfg, device="cpu").init_state()
    sim = tsim.Simulation(cfg, device="cpu")
    sim.run_scan(st, 12)
    launch.reset()
    sim.run_scan(st, 12)
    counts = chip_smoke.main_launches()
    rebuilds = counts["band_classify"]
    assert counts["table_build"] == rebuilds >= 2
    chip_smoke.check_runner_launches(counts, 12, rebuilds)
    bad = dict(counts, table_build=rebuilds + 1)
    with pytest.raises(RuntimeError, match="table builds"):
        chip_smoke.check_runner_launches(bad, 12, rebuilds)
    per_graph = chip_smoke.loop_launches(*sim._loops.values())
    for g, off in (("rebuild", -1), ("inner farmid", 1)):
        bad = dict(per_graph, **{g: dict(per_graph[g], table_build=(
            per_graph[g]["table_build"] + off))})
        with pytest.raises(RuntimeError, match="table build"):
            chip_smoke.check_builds("runner", bad)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("case", ["1M disk start state",
                                  "1M tools config (tile 256, super-supers)",
                                  "1M Plummer first rebuild, grown caps",
                                  "empty lists and pad ids"])
def test_kernel_live_rows_match_the_plain_build(card, case):
    """The kernel's live rows, in all four planes, and its counts equal
    build_cell_tables_torch's bit for bit, one launch a build, and the
    table sweep gives the same forces on both tables."""
    import chip_smoke

    cells, supers, ss, bands, cfg, ps = chip_smoke.tables_case(case)
    if case.startswith("1M Plummer"):
        assert int(bands.near_cnt.max()) > 8192
    launch.reset()
    got = tables.build_cell_tables(cells, supers, ss, bands)
    assert tables.LAUNCHES == {"table_build": 1}
    want = forces.build_cell_tables_torch(cells, supers, ss, bands)
    assert tables.live_diff(got, want, bands.near_idx.shape[1]) == []
    from nbody_tpu_torch.ops.cuda import forces as kern

    a, b = (kern.table_sweep(ps, x, cfg) for x in (got, want))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
