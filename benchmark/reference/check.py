"""The comparison that decides a run's `correct`, and the readings of
`force_err_p50`, from the frames that the program produced in the window.

A frame is F steps of Euler-Cromer from the state at its start (pos_a,
vel_a) to the state at its end (pos_b, vel_b, acc_b), where acc_b is the
acceleration the frame's last step applied.  That step started from
pos_b - vel_b dt.  For a seeded sample of bodies the reference gives, in
float64 (direct.accelerations over all N sources):

  a_a  at the frame's first positions, pos_a;
  a_b  at the last step's positions, pos_b - vel_b dt.

and the readings are, per sampled body,

  force_err  |acc_b - a_b| / |a_b|: the last step's force (the three
             sweeps, the held far+mid and the band classification as
             they reached that step);
  dv_err     |(vel_b - vel_a) - F dt (a_a + a_b) / 2| / |F dt (a_a +
             a_b) / 2|: the frame's velocity change against the
             reference's mean force over it (every step's force and the
             velocity half of the Euler-Cromer update; a frame that does
             not advance reads 100%);
  pos_err    |(pos_b - pos_a) - dx| / |dx|, dx = F dt vel_a + dt^2
             F (F + 1) / 6 (2 a_a + a_b): the frame's displacement
             against the sum dt (v_1 + ... + v_F) of the velocities that
             Euler-Cromer moves each step by, v_k = vel_a + dt (a_0 +
             ... + a_(k-1)), with the force a_j linear from a_a to a_b
             (the position half of the update: positions left where they
             were read 100%, moved by half of dt 50%).

Bodies whose speed reaches 0.9 MAX_SPEED at either end are left out of
dv_err and pos_err (the clamp bends their velocity change); the clamp itself is
held by `speed_max`, the largest speed of any body at the frame's end,
against MAX_SPEED.

The control is the same reference at the precision below the program's
float32, bfloat16, put in the program's place and read at the program's
frames: its state (positions and velocities) rounded to bfloat16, its
forces `direct.accelerations` in bfloat16 at those positions, its last
step's acceleration the one at the rounded pos_b - vel_b dt, and its
frame F bfloat16 updates v <- v + a_k dt, x <- x + v dt from the
rounded vel_a and pos_a, with a_k linear between its forces at the
frame's two ends.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from benchmark.reference.direct import accelerations


class Physics(NamedTuple):
    """The constants of the force law and the update."""

    g: float
    soft: float          # added to the squared distance
    dt: float
    max_speed: float


class Frame(NamedTuple):
    """A frame's start (pos_a, vel_a) and end (pos_b, vel_b, acc_b), [N, 3]
    float32, with the masses [N] and its step count."""

    pos_a: torch.Tensor
    vel_a: torch.Tensor
    pos_b: torch.Tensor
    vel_b: torch.Tensor
    acc_b: torch.Tensor
    mass: torch.Tensor
    steps: int


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=1))


def _quantiles(x: torch.Tensor) -> Dict[str, float]:
    """p50 and p99 in percent of a relative error."""
    q = torch.quantile(x.to(torch.float64),
                       torch.tensor([0.5, 0.99], dtype=torch.float64,
                                    device=x.device))
    return {"p50": 100.0 * float(q[0]), "p99": 100.0 * float(q[1])}


def last_step_positions(fr: Frame, phys: Physics) -> torch.Tensor:
    """[N, 3] float64: where the frame's last step started."""
    return fr.pos_b.to(torch.float64) - fr.vel_b.to(torch.float64) * phys.dt


def force_error(fr: Frame, rows: torch.Tensor, phys: Physics) -> float:
    """The median over `rows` of |acc_b - a_b| / |a_b|, in percent."""
    src = last_step_positions(fr, phys)
    a_b = accelerations(src[rows], src, fr.mass, phys.g, phys.soft)
    err = _norm(fr.acc_b[rows].to(torch.float64) - a_b) / _norm(a_b)
    return _quantiles(err)["p50"]


def frame_readings(fr: Frame, rows: torch.Tensor, phys: Physics,
                   control: bool = False) -> Dict[str, float]:
    """force_err, dv_err and pos_err at p50 and p99 (percent) and
    speed_max of one frame: the program's, or with `control` the
    control's read at the program's frame."""
    f64 = torch.float64
    src_b = last_step_positions(fr, phys)
    src_a = fr.pos_a.to(f64)
    a_a = accelerations(src_a[rows], src_a, fr.mass, phys.g, phys.soft)
    a_b = accelerations(src_b[rows], src_b, fr.mass, phys.g, phys.soft)
    steps, dt = fr.steps, phys.dt
    dv_ref = (0.5 * steps * dt) * (a_a + a_b)
    dx_ref = (steps * dt) * fr.vel_a[rows].to(f64) + (
        dt * dt * steps * (steps + 1) / 6.0) * (2.0 * a_a + a_b)
    speed = _norm(fr.vel_b.to(f64))
    if control:
        bf = torch.bfloat16
        c_a = accelerations(src_a.to(bf)[rows], src_a.to(bf), fr.mass,
                            phys.g, phys.soft, dtype=bf)
        c_b = accelerations(src_b.to(bf)[rows], src_b.to(bf), fr.mass,
                            phys.g, phys.soft, dtype=bf)
        acc = c_b.to(f64)
        v0, x0 = fr.vel_a[rows].to(bf), fr.pos_a[rows].to(bf)
        v, x = v0, x0
        dt_bf = torch.tensor(dt, dtype=bf, device=v.device)
        for k in range(steps):
            w = k / max(steps - 1, 1)
            a_k = (1.0 - w) * c_a + w * c_b
            v = v + a_k * dt_bf
            x = x + v * dt_bf
        dv = v.to(f64) - v0.to(f64)
        dx = x.to(f64) - x0.to(f64)
        speed = _norm(v.to(f64))
    else:
        acc = fr.acc_b[rows].to(f64)
        dv = fr.vel_b[rows].to(f64) - fr.vel_a[rows].to(f64)
        dx = fr.pos_b[rows].to(f64) - fr.pos_a[rows].to(f64)
    force = _norm(acc - a_b) / _norm(a_b)
    slow = ((_norm(fr.vel_a[rows].to(f64)) < 0.9 * phys.max_speed)
            & (_norm(fr.vel_b[rows].to(f64)) < 0.9 * phys.max_speed))
    dv_err = (_norm(dv - dv_ref) / _norm(dv_ref))[slow]
    pos_err = (_norm(dx - dx_ref) / _norm(dx_ref))[slow]
    f, d, p = _quantiles(force), _quantiles(dv_err), _quantiles(pos_err)
    return {"force_err_p50": f["p50"], "force_err_p99": f["p99"],
            "dv_err_p50": d["p50"], "dv_err_p99": d["p99"],
            "pos_err_p50": p["p50"], "pos_err_p99": p["p99"],
            "speed_max": float(speed.max())}


def worst(readings) -> Dict[str, float]:
    """Each number's largest reading over the frames."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit at or under it (a number that is not finite fails)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
