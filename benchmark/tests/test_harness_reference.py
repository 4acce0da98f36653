"""The plain reference: its blocked direct sum against a double loop at
N = 256, in float64 and, at the precision below, bfloat16; the check's
readings of an exact frame and of a frame that did not advance."""

import torch

from benchmark.reference import check, direct

torch.set_num_threads(2)


def _cloud(n, seed):
    gen = torch.Generator().manual_seed(seed)
    pos = (torch.rand((n, 3), generator=gen, dtype=torch.float64) - .5) * 2e3
    mass = 2 + 5 * torch.rand(n, generator=gen, dtype=torch.float64)
    return pos, mass


def _naive(pos, mass, g, soft):
    n = pos.shape[0]
    out = torch.zeros((n, 3), dtype=torch.float64)
    for i in range(n):
        for j in range(n):
            d = pos[j] - pos[i]
            out[i] += g * mass[j] * d / float(d @ d + soft) ** 1.5
    return out


def test_direct_sum_equals_a_double_loop():
    pos, mass = _cloud(256, 3)
    ref = _naive(pos, mass, 0.5, 50.0)
    got = direct.accelerations(pos, pos, mass, 0.5, 50.0, tgt_block=64)
    assert got.dtype == torch.float64
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-15)
    # targets apart from sources, and blocks smaller than the sources
    direct._BLOCK_ELEMS, keep = 64 * 32, direct._BLOCK_ELEMS
    try:
        part = direct.accelerations(pos[:100], pos, mass, 0.5, 50.0,
                                    tgt_block=64)
    finally:
        direct._BLOCK_ELEMS = keep
    assert torch.allclose(part, ref[:100], rtol=1e-12, atol=1e-15)


def test_bfloat16_is_the_precision_below():
    pos, mass = _cloud(256, 4)
    ref = _naive(pos, mass, 0.5, 50.0)
    low = direct.accelerations(pos, pos, mass, 0.5, 50.0,
                               dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16
    rel = ((low.double() - ref).norm(dim=1) / ref.norm(dim=1)).median()
    assert 1e-4 < float(rel) < 0.2


def _exact_frame(n, steps, phys, stay=False):
    """A frame integrated with the float64 direct sum (Euler-Cromer)."""
    pos, mass = _cloud(n, 5)
    vel = torch.zeros_like(pos)
    pos_a, vel_a = pos.clone(), vel.clone()
    acc = None
    for _ in range(steps):
        acc = direct.accelerations(pos, pos, mass, phys.g, phys.soft)
        if not stay:
            vel = vel + acc * phys.dt
            pos = pos + vel * phys.dt
    f32 = torch.float32
    return check.Frame(pos_a.to(f32), vel_a.to(f32), pos.to(f32),
                       vel.to(f32), acc.to(f32), mass.to(f32), steps)


def test_readings_of_a_sound_and_of_a_stuck_frame():
    phys = check.Physics(g=0.5, soft=50.0, dt=0.02, max_speed=500.0)
    rows = torch.arange(0, 300, 3)
    good = check.frame_readings(_exact_frame(300, 4, phys), rows, phys)
    assert good["force_err_p50"] < 1e-3 and good["dv_err_p50"] < 1.0
    stuck = check.frame_readings(_exact_frame(300, 4, phys, stay=True),
                                 rows, phys)
    assert stuck["dv_err_p50"] == 100.0
    ctl = check.frame_readings(_exact_frame(300, 4, phys), rows, phys,
                               control=True)
    assert ctl["force_err_p50"] > 10 * good["force_err_p50"]
    ok, checks = check.judge({"a": 1.0, "b": float("nan")},
                             {"a": 1.0, "b": 5.0})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 1.0}
