"""benchmark/work.py, the frozen work count, against the port's own
count (nbody_tpu_torch.bench.work) on structures the port builds on the
CPU: the adaptive runner's first rebuild and the unskinned build, at two
tiles.  Equal at the commit that froze it; a later change to the port's
count leaves the benchmark's as it was."""

import pytest
import torch

from benchmark import harness, work
from nbody_tpu_torch import bench
from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.tools import common

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _state(n, seed):
    from nbody_tpu_torch.state import ParticleState
    from benchmark.ics import disk_msvc

    return ParticleState.create(*disk_msvc.make(n, seed, 0.5), device=CPU)


@pytest.mark.parametrize("tile,skins", [(128, True), (128, False),
                                        (512, True)])
def test_work_equals_the_ports_count(tile, skins):
    cfg = PRESETS["v5_bench"].replace(n=6000, force_tile=tile,
                                      use_pallas=False)
    state = _state(cfg.n, 7)
    if skins:
        rebuild, args = common.first_rebuild(state, cfg)
        (ps, *_), (_, ss, bands, tables, _), _ = rebuild(*args)
    else:
        ps, ms, cs, *_ = common.sorted_padded(state, cfg)
        _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    mine = work.work(cfg.force_tile, cfg.near_cap, ps, ss, bands, tables)
    theirs = bench.work(cfg, ps, ss, bands, tables)
    for k in ("far_sweep", "table_sweep", "near_span"):
        assert mine[k]["live"] == theirs[k]["live"] > 0
        assert mine[k]["bytes"] == theirs[k]["bytes"]


def test_first_structure_serves_and_bounds():
    cfg = PRESETS["v5_bench"].replace(n=6000, force_tile=128,
                                      use_pallas=False)
    state = _state(cfg.n, 3)
    first = harness.first_structure(cfg, state)
    assert 1 <= first["serves"] <= cfg.rebuild_every
    for k, (sec, bound) in first["least"].items():
        w = first["work"][k]
        assert sec == max(20 * w["live"] / work.PEAK_FP32,
                          w["bytes"] / work.PEAK_BYTES)
        assert bound in ("compute", "memory")
    k1 = harness.first_structure(cfg.replace(rebuild_every=1), state)
    assert k1["serves"] == 1
