"""Simulation pipelines, the band-reuse runners and the user-facing
`Simulation`.

`step_barnes_hut` rebuilds everything each step, as the reference's
simulationStep() does (nbody_v5.cu:298-325): bounding cube -> Morton
codes -> stable sort -> adaptive cells and band structures -> the three
force sweeps -> Euler-Cromer; with force_fn="reference" the force is the
per-particle rope walk over the escape-linearised tree instead.
`step_direct` is the O(N^2) oracle.
Particles stay in their original order across steps; the Morton
permutation is internal to a step (and to a run of the runners below).

Band reuse: a rebuild inflates every MAC by per-particle skin margins
(drift bounds), so the frozen order, classification and source moments
stay valid while the targets move; the far sweeps evaluate at live
target positions and the exact near band is live on both sides.
`make_cycle_runner` rebuilds every K steps; `make_adaptive_runner` (the
shipping path) sizes each particle's skin to its local cell width and
reuses the structure for exactly its validity horizon.  Either may hold
the smooth far+mid component for R = cfg.hold_farmid steps (r-RESPA).
The design history is in nbody_tpu/models/simulation.py.

On CUDA the adaptive runner's rebuild and inner steps, each fixed-K
cycle, and the per-step rebuild and the direct step of
`Simulation.step` run as captured CUDA graphs (utils/graphs.Graphed)
over buffers they own: the counterpart of the JAX package's one jitted
program, with no per-kernel launch from the host.  The host keeps the
schedule as integers and replays the graph each rebuild, cycle or step
needs.

Band caps: every band build reports, beside its overflow flags
(BUILD_FLAGS), what it demands of each capacity (DEMANDS).  The adaptive
loop reads both with its validity horizon, and a build with a flag set is
never swept: the loop grows the flagged caps (grown_config, within
cfg.band_budget_gib), captures its graphs again and redoes the build, so
no pair is dropped.  The caps it grew to last for the loop's life.  The
per-step rebuild and the fixed-K cycles keep their caps; `Simulation.run`
reads their flags at each frame's sync and raises on a build that dropped
pairs.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState, default_device
from nbody_tpu_torch.ops import bbox, morton, forces, integrate as integ
from nbody_tpu_torch.ops.cells import (CELL_DEMAND, build_source_cells,
                                       capacity_demand)
from nbody_tpu_torch.ops.tree import build_tree
from nbody_tpu_torch.utils.graphs import Graphed, capturable
from nbody_tpu_torch.utils.profiling import span


def sort_by_morton(pos: torch.Tensor, cfg: SimConfig):
    """(codes_sorted int64 [N], perm, lo, size) at cfg.morton_bits."""
    lo, size = bbox.bounding_cube(pos)
    encode = morton.encode63 if cfg.morton_bits == 63 else morton.encode30
    codes_s, perm = morton.morton_sort(encode(pos, lo, size))
    return codes_s, perm, lo, size


def compute_bh_acc(pos: torch.Tensor, mass: torch.Tensor, cfg: SimConfig,
                   force_fn: str = "tiled",
                   stats: Optional[dict] = None) -> torch.Tensor:
    """Barnes-Hut accelerations in the particles' original order.

    force_fn: "tiled" (the production band decomposition, hand kernels
    when cfg.use_pallas; `stats` receives its build's flags and demand,
    build_report, under "report") or "reference" (the per-particle rope
    walk over the escape-linearised tree; `stats` collects its iteration
    and host-read counts)."""
    if force_fn not in ("tiled", "reference"):
        raise ValueError(f"unknown force_fn {force_fn}")
    n = pos.shape[0]
    codes_s, perm, _, size = sort_by_morton(pos, cfg)
    pos_s, mass_s = pos[perm], mass[perm]
    if force_fn == "tiled":
        pos_p, mass_p, codes_p = forces.pad_sorted(pos_s, mass_s, codes_s,
                                                   cfg.force_tile)
        if stats is None:
            acc_s = forces.bh_forces_grouped(pos_p, mass_p, codes_p, cfg)[:n]
        else:
            demand = torch.zeros(len(forces.BAND_DEMAND), dtype=torch.int32,
                                 device=pos.device)
            cells, ss, bands, tables = forces.build_bands(
                pos_p, mass_p, codes_p, cfg, demand=demand)
            stats["report"] = build_report(build_flags(cells, bands), cells,
                                           demand)
            acc_s = forces.apply_bands(pos_p, mass_p, ss, bands, tables,
                                       cfg)[:n]
    else:
        # the tree is 30-bit; a 63-bit key's top 30 bits are a prefix of
        # it, so the sorted order holds for the truncated codes
        codes30 = ((codes_s >> 33) & 0x3FFFFFFF if cfg.morton_bits == 63
                   else codes_s)
        tree = build_tree(codes30, pos_s, mass_s, size)
        acc_s = forces.bh_forces_reference(pos_s, tree, cfg, stats=stats)
    out = torch.empty_like(acc_s)
    out[perm] = acc_s                   # back to the original order
    return out


def step_barnes_hut(state: ParticleState, cfg: SimConfig,
                    force_fn: str = "tiled",
                    stats: Optional[dict] = None) -> ParticleState:
    return integ.integrate(state, compute_bh_acc(state.pos, state.mass, cfg,
                                                 force_fn, stats), cfg)


def step_direct(state: ParticleState, cfg: SimConfig) -> ParticleState:
    return integ.integrate(state, forces.direct_forces(state.pos, state.mass,
                                                       cfg), cfg)


# ---------------------------------------------------------------------------
# Band reuse: skins, validity horizon, held far+mid
# ---------------------------------------------------------------------------


def _pad_cycle_state(state: ParticleState, b: int):
    """Pad to a force_tile multiple with massless clones of the last
    particle (velocity cloned too, so pads track the cloud); `orig` maps
    each row to its original index (pads -> n, dropped on scatter)."""
    n = state.n
    pad = -(-n // b) * b - n
    orig = torch.cat([torch.arange(n, device=state.device),
                      torch.full((pad,), n, device=state.device)])
    if pad == 0:
        return state.pos, state.vel, state.mass, state.acc, orig
    return (torch.cat([state.pos, state.pos[-1:].expand(pad, 3)]),
            torch.cat([state.vel, state.vel[-1:].expand(pad, 3)]),
            torch.cat([state.mass, state.mass.new_zeros(pad)]),
            torch.cat([state.acc, state.acc.new_zeros(pad, 3)]),
            orig)


def _unpad(pos, vel, acc, orig, n: int, mass0) -> ParticleState:
    """Scatter Morton-ordered padded rows back to the original order."""
    def back(x):
        out = x.new_zeros((n + 1, 3))   # row n takes the pads
        out[orig] = x
        return out[:n]

    return ParticleState(pos=back(pos), vel=back(vel), mass=mass0,
                         acc=back(acc))


def drift_bound(v: torch.Tensor, a: torch.Tensor, cfg: SimConfig,
                k) -> torch.Tensor:
    """Conservative per-particle travel bound over k steps (speed v,
    acceleration a magnitudes), scaled by cfg.skin_safety and capped by
    the MAX_SPEED clamp when active (nbody_v5.cu:262-269).  `k` is an int
    or a float32 scalar tensor."""
    drift = (v * cfg.dt * k
             + 0.5 * a * cfg.dt * cfg.dt * k * (k + 1)) * cfg.skin_safety
    if cfg.clamp_speed:
        drift = torch.clamp(drift, max=cfg.max_speed * cfg.dt * k)
    return drift


_HORIZON_HEADROOM = 1.1


def adaptive_drift(v, a, codes_s, box_size, cfg: SimConfig, k=None):
    """Width-capped skin envelopes: min(k-step travel bound,
    skin_width_cap * local Morton cell width), the width floored at
    box_size * skin_width_floor (the 30-bit lattice width), so one dense
    run cannot pin the global validity horizon at 1.  `k` defaults to
    cfg.rebuild_every; the adaptive runner passes its self-tuned
    envelope horizon."""
    if k is None:
        k = cfg.rebuild_every
    drift_k = drift_bound(v, a, cfg, k)
    w_loc = forces.local_width(codes_s, box_size, cfg.force_tile,
                               cfg.morton_bits)
    w_loc = torch.maximum(w_loc, box_size * cfg.skin_width_floor)
    return torch.minimum(drift_k, cfg.skin_width_cap * w_loc)


def validity_horizon(v, a, drift, cfg: SimConfig) -> torch.Tensor:
    """The largest step count s such that no particle's bounded travel
    (v s dt + 1/2 a (s dt)^2, with headroom) exceeds its skin envelope,
    clipped to [max(1, min(horizon_floor, K)), K]; a device int64
    scalar.  A horizon_floor above 1 lets the fastest tail run past its
    envelope for up to floor-1 steps."""
    head = _HORIZON_HEADROOM
    aq = 0.5 * a * cfg.dt * cfg.dt * head
    bq = torch.clamp(v * cfg.dt * head, min=1e-9)
    s_lin = drift / bq
    s_quad = (torch.sqrt(bq * bq + 4.0 * aq * drift) - bq) / torch.clamp(
        2.0 * aq, min=1e-12)
    s_i = torch.where(aq > 1e-9, s_quad, s_lin)
    lo = max(1, min(cfg.horizon_floor, cfg.rebuild_every))
    # clip before the integer cast: a near-still cloud gives s ~ 1e12
    return torch.clamp(torch.floor(s_i.min()), lo,
                       cfg.rebuild_every).to(torch.int64)


def hold_predict_pos(pos, vel, acc, tau, cfg: SimConfig):
    """Target sampling positions of a held far+mid refresh
    (cfg.hold_predict): the current positions (0), the ballistic
    midpoint (1) or the quadratic midpoint (2).  0 ships: midpoint
    prediction measured harmful in the contracted core.  `tau` is a float
    or a 0-d float64 tensor (the adaptive loop's, which a captured graph
    reads at replay); both give the same float32 result, since 0.5 tau^2
    is then computed in float64, as the float path computes it."""
    if cfg.hold_predict == 0:
        return pos
    p = pos + vel * tau
    if cfg.hold_predict >= 2:
        p = p + acc * (0.5 * tau * tau)
    return p


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=1))


def k_next_of(k_env: torch.Tensor, s_valid: torch.Tensor,
              overflowed: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The next envelope horizon, ~2 s_valid (calm epochs grow back to K
    in a few rebuilds), halved instead when this build's skins overflowed
    any band cap (a standing theta violation for the overflowed pairs).
    The sharded runner's feedback; the single-device adaptive loop never
    sweeps an overflowed build, and takes the first branch on the host."""
    return torch.where(overflowed, torch.clamp(k_env // 2, min=1),
                       torch.clamp(2 * s_valid, 1, cfg.rebuild_every))


def next_envelope(s_valid: int, cfg: SimConfig) -> int:
    """The adaptive loop's next envelope horizon, on the host: k_next_of
    for a build that fits its caps, clip(2 s_valid, 1, K)."""
    return min(max(2 * s_valid, 1), cfg.rebuild_every)


# the seven overflow flags of a band build, in the order of build_flags:
# the five band lists', the adaptive cells' and the grandchild segments'
BUILD_FLAGS = ("ss", "sup", "mid", "cmid", "near", "cells", "g2")
# what a band build demands of each capacity, in the order of
# build_report: the band lists and near windows (forces.BAND_DEMAND), the
# cell slots and the grandchild segments (cells.CELL_DEMAND)
DEMANDS = forces.BAND_DEMAND + CELL_DEMAND
# the flags of a build that swept coarser monopoles in place of what it
# dropped (a grandchild overflow only sends children to exact P2P)
_DROPPING = BUILD_FLAGS[:6]


def _band_flags(bands) -> list:
    return [getattr(bands, f"{f}_overflow") for f in BUILD_FLAGS[:5]]


def bands_overflowed(bands) -> torch.Tensor:
    """Any band list of `bands` past its cap (a device bool)."""
    return torch.stack(_band_flags(bands)).any()


def build_flags(cells, bands) -> torch.Tensor:
    """The overflow flags of one band build (build_bands' cells and
    bands): a device bool [7], BUILD_FLAGS."""
    return torch.stack(_band_flags(bands) + [cells.overflow,
                                             cells.overflow_g2])


def build_report(flags: torch.Tensor, cells,
                 band_demand: torch.Tensor) -> torch.Tensor:
    """One band build's flags (build_flags) and demand, int64 [15]:
    BUILD_FLAGS as 0 or 1, then DEMANDS (`band_demand` is the int32 [6]
    that build_bands filled)."""
    return torch.cat([flags.to(torch.int64), band_demand.to(torch.int64),
                      capacity_demand(cells)])


def _count_build(counts: torch.Tensor, report: torch.Tensor) -> None:
    """Add one build's report (build_report) to a device int64 [16] tally
    in place: [0:7] the builds with each flag set, [7] those with any set,
    [8:16] the largest demand of each kind.  Inside a captured graph, so
    that every replay counts with no host read."""
    flags = report[:len(BUILD_FLAGS)]
    counts[:len(BUILD_FLAGS)].add_(flags)
    counts[len(BUILD_FLAGS):len(BUILD_FLAGS) + 1].add_(flags.amax())
    torch.maximum(counts[len(BUILD_FLAGS) + 1:], report[len(BUILD_FLAGS):],
                  out=counts[len(BUILD_FLAGS) + 1:])


def _new_tally(device) -> torch.Tensor:
    return torch.zeros(len(BUILD_FLAGS) + 1 + len(DEMANDS), dtype=torch.int64,
                       device=device)


def _round_cap(demand: int) -> int:
    """A grown capacity: the power of two at or above `demand`, at least
    64.  Doubling keeps the growths of a long run few, and a capacity
    sets the width every later build gathers and writes, so the states
    of one configuration share a few widths instead of one each."""
    return max(64, 1 << (max(demand, 1) - 1).bit_length())


def caps_in_force(cfg: SimConfig) -> dict:
    """The capacities a build of cfg has, by DEMANDS name: the list caps,
    the near window slots, the cell slots and the grandchild segments."""
    return {"ss": cfg.ss_cap, "sup": cfg.sup_cap, "mid": cfg.mid_cap,
            "cmid": cfg.cmid_cap, "near": cfg.near_cap,
            "win": cfg.win_cap_eff, "cells": cfg.cell_capacity,
            "g2": min(cfg.g2_cap_factor, 8) * 8 * cfg.cell_capacity}


def grown_config(cfg: SimConfig, flags, demand) -> SimConfig:
    """cfg with each flagged capacity (BUILD_FLAGS, 0 or 1) grown to the
    power of two at or above its demand (DEMANDS; _round_cap); a near
    flag grows whichever of the near list and its windows is past its
    cap.  Caps never shrink.  Raises when the grown band and cell
    tables (SimConfig.band_bytes) pass cfg.band_budget_gib, or the
    classifier kernel's lists its shared memory, naming the demanded
    caps."""
    f = dict(zip(BUILD_FLAGS, flags))
    d = dict(zip(DEMANDS, demand))
    kw = {}
    for name in ("ss", "sup", "mid", "cmid", "near"):
        cap = getattr(cfg, f"{name}_cap")
        if f[name] and d[name] > cap:
            kw[f"{name}_cap"] = max(cap, _round_cap(d[name]))
    if f["near"] and d["win"] > cfg.win_cap_eff:
        kw["win_cap"] = max(cfg.win_cap, _round_cap(d["win"]))
    if f["cells"]:
        need = _round_cap(d["cells"])
        kw["cell_cap_factor"] = max(cfg.cell_cap_factor,
                                    -(-(need - 64) // cfg.n_groups))
    grown = cfg.replace(**kw)
    if f["g2"] or f["cells"]:
        c_cap = 8 * grown.cell_capacity
        g2 = max(cfg.g2_cap_factor, -(-d["g2"] // c_cap))
        if g2 != cfg.g2_cap_factor:
            grown = grown.replace(g2_cap_factor=min(g2, 8))
    if grown == cfg:
        raise RuntimeError(f"a band build overflowed {f} with demand {d}, "
                           f"which the caps in force {caps_in_force(cfg)} "
                           "hold: no cap to grow")
    wanted = ", ".join(f"{k}={v}" for k, v in caps_in_force(grown).items()
                       if v != caps_in_force(cfg)[k])
    budget = cfg.band_budget_gib * 2**30
    if grown.band_bytes > budget:
        raise RuntimeError(
            f"band caps demanded past band_budget_gib={cfg.band_budget_gib}: "
            f"{wanted} take {grown.band_bytes / 2**30:.3f} GiB of band and "
            "cell tables; raise band_budget_gib or lower theta")
    if grown.use_pallas:
        from nbody_tpu_torch.ops.cuda import classify

        if classify.smem_bytes(grown) > classify.SMEM_LIMIT:
            raise RuntimeError(
                f"band caps demanded past the classifier kernel's shared "
                f"memory: {wanted} take {classify.smem_bytes(grown)} B of "
                f"{classify.SMEM_LIMIT}")
    return grown


def _adaptive_rebuild_fn(cfg: SimConfig):
    """One adaptive band rebuild: Morton re-sort, the permutation applied
    to every per-particle field (and to the held far+mid acceleration
    when it spans rebuilds), self-tuned skin envelopes, band build,
    validity horizon and envelope feedback.

    rebuild(pos, vel, mass, acc, orig, k_env, afm=None) returns
    (fields, built, (s_valid, report)) with fields = (pos, vel, mass,
    acc, orig, afm) in the new order (afm None when not given), built =
    (cells, supers, bands, tables, rctx), build_bands' four results and
    what refresh_farmid needs, the validity horizon (a device int64
    scalar) and the build's flags and demand (build_report).  It writes
    nothing back: the caller picks the next envelope horizon."""

    def rebuild(pos, vel, mass, acc, orig, k_env, afm=None):
        codes_s, perm, box_lo, size = sort_by_morton(pos, cfg)
        pos, vel, mass, acc, orig = (pos[perm], vel[perm], mass[perm],
                                     acc[perm], orig[perm])
        if afm is not None:
            afm = afm[perm]
        v, a = _norms(vel), _norms(acc)
        drift = adaptive_drift(v, a, codes_s, size, cfg,
                               k=k_env.to(torch.float32))
        demand = torch.zeros(len(forces.BAND_DEMAND), dtype=torch.int32,
                             device=pos.device)
        cells, supers, bands, tables = forces.build_bands(
            pos, mass, codes_s, cfg, drift=drift, demand=demand)
        s_valid = validity_horizon(v, a, drift, cfg)
        # what refresh_farmid needs to recompute moments at this cut
        rctx = (codes_s, drift, box_lo, size)
        return ((pos, vel, mass, acc, orig, afm),
                (cells, supers, bands, tables, rctx),
                (s_valid, build_report(build_flags(cells, bands), cells,
                                       demand)))

    return rebuild


def _graphed(cfg: SimConfig, graphs: bool) -> bool:
    """Whether a runner of `cfg` captures graphs (on CUDA): with the hand
    kernels only.  The plain sweeps (cfg.use_pallas=False, the command
    line's --no-pallas) read their live widths back to the host, which
    no capture can hold, so they run eagerly."""
    return graphs and cfg.use_pallas


class _PaddedLoop:
    """The padded fields of _pad_cycle_state (pos, vel, mass, acc, orig)
    as buffers a loop owns, with the body count `n` and the masses
    `mass0` of the state they came from."""

    def _own(self, pos, vel, mass, acc, orig) -> None:
        self.pos, self.vel, self.mass, self.acc, self.orig = (
            x.clone() for x in (pos, vel, mass, acc, orig))

    def _load(self, state: ParticleState) -> None:
        """`state`'s padded fields into the buffers; its padded row count
        must be the loop's."""
        fields = _pad_cycle_state(state, self.cfg.force_tile)
        if fields[0].shape != self.pos.shape:
            raise ValueError(f"{state.n} bodies pad to {fields[0].shape[0]} "
                             f"rows, the loop has {self.pos.shape[0]}")
        self._store(*fields)

    def _store(self, pos, vel, mass, acc, orig) -> None:
        for buf, x in zip((self.pos, self.vel, self.mass, self.acc,
                           self.orig), (pos, vel, mass, acc, orig)):
            buf.copy_(x)

    def snapshot(self) -> ParticleState:
        with span("nbody.loop.snapshot"):
            return _unpad(self.pos, self.vel, self.acc, self.orig, self.n,
                          self.mass0)


class _AdaptiveLoop(_PaddedLoop):
    """The adaptive schedule as a host loop, one `step()` per step.

    A rebuild happens when the current structure's validity horizon is
    used up; it reads the build's report once (the one host sync of a
    rebuild: s_valid, the build's flags and its demand, one copy), and
    s_valid sets the horizon, the next envelope horizon k_env =
    clip(2 s_valid, 1, K) and, with cfg.span_age_mult, the hold limit
    r_eff = clip(span_age_mult * s_valid, 1, R).  Every other decision is
    taken from host integers, so an inner step (far+mid refresh or not,
    with or without refresh_moments, exact near, integrate) reads nothing
    back from the device.

    A build with any flag set is not swept.  Inside the span
    nbody.caps.grow the loop grows the flagged caps past their demand
    (grown_config, which raises past cfg.band_budget_gib), makes its
    graphs again at the grown config and redoes the build from the state
    the failed one left: the same bodies, already in the order the redone
    sort gives, and the same k_env, which no graph writes.  It repeats
    until a build fits (a list's demand counts only what the lists before
    it kept).  The grown config is the loop's `cfg` from then on.

    The held far+mid is refreshed on the first step after a rebuild and
    every R steps; with cfg.farmid_span_rebuilds it is permuted along
    with the rebuild and only its age (limit r_eff) refreshes it.  With
    cfg.refresh_moments a refresh that is not the first step after a
    rebuild recomputes every source moment from live positions at the
    frozen cut (forces.refresh_farmid).

    The loop owns its buffers: the padded fields (pos, vel, mass, acc,
    orig), the held far+mid (afm), the envelope horizon k_env and the
    refresh's prediction time tau (0-d, float64).  The rebuild and each
    kind of inner step (no refresh, a refresh from the frozen moments, a
    refresh that recomputes them) read the buffers and write their
    results back into them, so on CUDA each is one captured graph
    (utils/graphs.Graphed), replayed at every rebuild and step, unless
    `graphs` is False or the config has no hand kernels (_graphed); the
    host keeps the schedule and picks the graph.
    The rebuild graph's live outputs are the frozen structures
    (`built`) that the inner-step graphs read.  `load` starts the loop
    again from another state of the same padded row count, reusing the
    graphs and the caps.

    Counters that `load` keeps, all on the host: `builds` (rebuilds),
    `start_rebuilds` (the first rebuild after each load or construction;
    the others ran out a validity horizon), `builds_redone` (builds with
    a flag set, thrown away), `cap_growths` (caps grown, one a cap each
    time it grows), `overflows` (the builds with each BUILD_FLAGS flag
    set, then with any) and `demand_max` (the largest demand of each
    DEMANDS kind).  `n_rebuilds` counts the rebuilds since the last load.

    The schedule is shared with the multi-device loop
    (parallel/shard.py), which overrides the rebuild (`_build`), the
    moment refresh, the near band and the snapshot, and runs eagerly;
    its rebuild counts no overflows and grows no cap."""

    def __init__(self, cfg: SimConfig, state: ParticleState,
                 graphs: bool = True):
        graphs = _graphed(cfg, graphs)
        self._start(cfg, state.n, state.mass,
                    *_pad_cycle_state(state, cfg.force_tile), graphs=graphs)
        self._make_rebuild()

    def _start(self, cfg: SimConfig, n: int, mass0, pos, vel, mass, acc,
               orig, graphs: bool) -> None:
        """The buffers over the (padded) rows the loop integrates, its
        inner-step graphs, and the schedule's state."""
        self.cfg = cfg
        self.r = max(1, cfg.hold_farmid)
        self.span = cfg.farmid_span_rebuilds
        self._own(pos, vel, mass, acc, orig)
        dev = self.pos.device
        self.afm = torch.zeros_like(self.pos)
        self.k_env = torch.empty((), dtype=torch.int64, device=dev)
        self.tau = torch.zeros((), dtype=torch.float64, device=dev)
        self.overflows = [0] * (len(BUILD_FLAGS) + 1)
        self.demand_max = [0] * len(DEMANDS)
        self.builds = self.start_rebuilds = 0
        self.builds_redone = self.cap_growths = 0
        self._graphs_on = graphs
        self._make_steps()
        self._reset(n, mass0)

    def _make_steps(self) -> None:
        """The inner-step graphs, in a memory pool of their own: the
        loop's graphs replay one at a time on one stream and keep their
        results in the buffers or in the rebuild's live outputs, so they
        share one pool."""
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._graphs_on and capturable(self.pos.device)
                      else None)
        self._steps = {kind: self._graphed(
            self._inner, "inner" if kind is None else f"inner.{kind}",
            (kind,)) for kind in (None, "farmid", "refreshed")}

    def _make_rebuild(self) -> None:
        self._rebuild_fn = _adaptive_rebuild_fn(self.cfg)
        self._rebuild_graph = self._graphed(self._rebuild_body, "rebuild")

    def _graphed(self, fn, name: str, args: tuple = ()) -> Graphed:
        return Graphed(fn, (self.pos, self.vel, self.mass, self.acc,
                            self.orig, self.afm, self.k_env),
                       self.pos.device, name, self._graphs_on, self._pool,
                       args)

    def _reset(self, n: int, mass0) -> None:
        self.n = n
        self.mass0 = mass0
        # fills, not copies from the host (which would synchronize)
        self.k_env.fill_(self.cfg.rebuild_every)
        self.afm.zero_()
        # span: the age starts at R, so the very first step refreshes
        self.afm_age = self.r if self.span else 0
        self.left = 0          # steps the current structure stays valid
        self.j = 0             # steps since the last rebuild
        self.r_eff = self.r
        self.n_rebuilds = 0

    def load(self, state: ParticleState) -> None:
        """Start again from `state`, whose padded row count must be the
        loop's: its fields into the buffers, and k_env, the held far+mid
        and the host counters as a new loop has them, so that two runs
        from one state are the same run."""
        self._load(state)
        self._reset(state.n, state.mass)

    def _rebuild_body(self):
        """The rebuild over the buffers: the fields (and the held far+mid
        when it spans rebuilds) in the new order; returns (built, report)
        with report = [s_valid, build_report], int64 [16]."""
        fields, built, (s_valid, report) = self._rebuild_fn(
            self.pos, self.vel, self.mass, self.acc, self.orig, self.k_env,
            self.afm if self.span else None)
        self._store(*fields[:5])
        if self.span:
            self.afm.copy_(fields[5])
        return built, torch.cat([s_valid.reshape(1), report])

    def _build_once(self):
        """One build at the loop's caps: (s_valid, flags, demand), read
        in one copy, tallied into the counters."""
        self.built, report = self._rebuild_graph()
        with span("nbody.rebuild.horizon_read"):
            r = report.tolist()
        flags, demand = r[1:1 + len(BUILD_FLAGS)], r[1 + len(BUILD_FLAGS):]
        for i, f in enumerate(flags + [max(flags)]):
            self.overflows[i] += f
        self.demand_max = [max(a, b) for a, b in zip(self.demand_max,
                                                     demand)]
        return r[0], flags, demand

    def _grow(self, flags, demand) -> None:
        """The loop at caps past `demand`: its config, its rebuild and
        inner-step graphs made again (captured at their next call)."""
        cfg = grown_config(self.cfg, flags, demand)
        before, after = caps_in_force(self.cfg), caps_in_force(cfg)
        self.cap_growths += sum(after[k] != before[k] for k in after)
        self.cfg = cfg
        self.built = None
        self._make_steps()
        self._make_rebuild()

    def _build(self) -> int:
        """Rebuild: the buffers in the new order, self.built and k_env;
        returns the validity horizon.  A build with a flag set grows the
        caps and is done again before any step sweeps it."""
        s_valid, flags, demand = self._build_once()
        if any(flags):
            with span("nbody.caps.grow"):
                while any(flags):
                    self._grow(flags, demand)
                    self.builds_redone += 1
                    s_valid, flags, demand = self._build_once()
        self.k_env.fill_(next_envelope(s_valid, self.cfg))
        return s_valid

    def rebuild(self) -> None:
        with span("nbody.rebuild"):
            s_valid = self._build()
        self.left, self.j = s_valid, 0
        self.start_rebuilds += self.n_rebuilds == 0
        self.n_rebuilds += 1
        self.builds += 1
        if self.span and self.cfg.span_age_mult > 0:
            self.r_eff = min(max(self.cfg.span_age_mult * s_valid, 1), self.r)

    def _farmid(self, p_mid: torch.Tensor) -> torch.Tensor:
        _, supers, _, tables, _ = self.built
        return forces.apply_farmid(p_mid, supers, tables, self.cfg)

    def _farmid_refreshed(self, p_mid: torch.Tensor) -> torch.Tensor:
        """Far+mid with every source moment recomputed from the live
        positions at the frozen cut."""
        _, _, bands, _, rctx = self.built
        return forces.refresh_farmid(self.pos, self.mass, *rctx, bands,
                                     self.cfg, tgt_pos=p_mid)

    def _near(self) -> torch.Tensor:
        bands = self.built[2]
        return forces.apply_near(self.pos, self.pos, self.mass, bands,
                                 self.cfg)

    def _inner(self, refresh: Optional[str]) -> None:
        """One inner step over the buffers.  With `refresh` ("farmid":
        from the frozen moments, "refreshed": every moment recomputed)
        far+mid is evaluated afresh at the positions hold_predict samples
        `tau` ahead; then the near band and the integration."""
        cfg = self.cfg
        if refresh is not None:
            p_mid = hold_predict_pos(self.pos, self.vel, self.acc, self.tau,
                                     cfg)
            self.afm.copy_(self._farmid_refreshed(p_mid)
                           if refresh == "refreshed" else self._farmid(p_mid))
        a = self.afm + self._near()
        st = integ.integrate(ParticleState(pos=self.pos, vel=self.vel,
                                           mass=self.mass, acc=a), a, cfg)
        for buf, x in ((self.pos, st.pos), (self.vel, st.vel),
                       (self.acc, a)):
            buf.copy_(x)

    def step(self) -> None:
        cfg = self.cfg
        if self.left <= 0:
            self.rebuild()
        if self.span:
            refresh = self.afm_age >= self.r_eff
        else:
            refresh = self.j == 0 or self.afm_age >= self.r
        kind = None
        if refresh:
            self.tau.fill_(0.5 * (self.r_eff - 1) * cfg.dt)
            kind = ("refreshed" if cfg.refresh_moments and self.j > 0
                    else "farmid")
            self.afm_age = 1
        else:
            self.afm_age += 1
        self._steps[kind]()
        self.left -= 1
        self.j += 1


def _loop_for(loops: dict, kind, cfg: SimConfig, state: ParticleState,
              graphs: bool):
    """The loop of class `kind` in `loops` for the state's padded row
    count and device, loaded with `state`; made on first use, its graphs
    captured as it meets them."""
    rows = -(-state.n // cfg.force_tile) * cfg.force_tile
    key = (cfg, rows, state.device)
    with span("nbody.loop.load"):
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = kind(cfg, state, graphs)
        else:
            loop.load(state)
    return loop


def _run_adaptive(loops: dict, cfg: SimConfig, state: ParticleState,
                  n_steps: int, graphs: bool = True):
    """n_steps of the adaptive schedule from `state`, starting with a
    rebuild, on the adaptive loop of `loops` (_loop_for): (the state
    after, the number of rebuilds)."""
    loop = _loop_for(loops, _AdaptiveLoop, cfg, state, graphs)
    for _ in range(n_steps):
        loop.step()
    return loop.snapshot(), loop.n_rebuilds


def make_adaptive_runner(cfg: SimConfig, n_steps: int,
                         return_stats: bool = False, graphs: bool = True):
    """A function advancing a state by n_steps with adaptive,
    step-granular band rebuilds (cfg.adaptive_rebuild), starting with a
    rebuild.  Each rebuild gives every particle the envelope
    min(v dt K safety, skin_width_cap * local cell width) and reuses the
    structure for exactly its validity horizon, so the hot core falls
    back to per-step rebuilds while calm epochs coast for ~K steps.
    With return_stats it returns (state, number of rebuilds).  On CUDA
    the rebuild and the inner steps run as captured graphs (unless
    `graphs` is False), which the function keeps for each padded row
    count it meets and replays in its later calls."""
    loops: dict = {}

    def run(state: ParticleState):
        out, n_rb = _run_adaptive(loops, cfg, state, n_steps, graphs)
        return (out, n_rb) if return_stats else out

    return run


class AdaptiveStepper:
    """The adaptive runner's schedule split at host-call boundaries, for
    interactive use: positions in Morton order, the frozen band
    structures, the validity countdown and the held far+mid stay on the
    device across `advance` calls, so a viewer stepping a few steps per
    frame rebuilds only when the physics demands it (`run_scan` starts
    every call with a rebuild).  The first rebuild happens here.  The
    stepper's loop keeps its captured graphs (on CUDA) across calls."""

    def __init__(self, cfg: SimConfig, state: ParticleState):
        self.cfg = cfg
        self._loop = _AdaptiveLoop(cfg, state)
        self._loop.rebuild()
        self.steps_done = 0

    def advance(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self._loop.step()
        self.steps_done += n_steps

    @property
    def n_rebuilds(self) -> int:
        return self._loop.n_rebuilds

    @property
    def pos_sorted(self) -> torch.Tensor:
        """Live positions in the internal Morton order, padded with
        clones of the last particle (enough for rendering); the loop's
        buffer, which the next `advance` overwrites."""
        return self._loop.pos

    @property
    def vel_sorted(self) -> torch.Tensor:
        return self._loop.vel

    def snapshot(self) -> ParticleState:
        """The full state in the original particle order."""
        return self._loop.snapshot()


def _cycle_hold(cfg: SimConfig, k: int) -> int:
    """The far+mid hold of a k-step cycle: cfg.hold_farmid, or 1 when it
    does not divide k."""
    r = max(1, cfg.hold_farmid)
    return 1 if k % r else r


class _CycleLoop(_PaddedLoop):
    """Fixed-K cycles over buffers the loop owns (_PaddedLoop), one
    `cycle(k)` a cycle.

    A cycle of k steps re-sorts the rows by Morton code, writes the
    permuted fields back into the buffers, builds the bands with skins
    from the uncapped k-step drift bound, and runs k // r sub-cycles of a
    far+mid evaluation followed by r steps of the exact near band and
    the integration (r = _cycle_hold).  On CUDA each cycle length is one
    captured graph (utils/graphs.Graphed), replayed for every cycle of
    that length, unless `graphs` is False or the config has no hand
    kernels (_graphed); the graphs keep their results in the buffers and
    share one pool.  `load` starts the loop again from another state of
    the same padded row count, reusing the graphs; it keeps the counters
    `builds` (cycles run) and `tally`, a device int64 [16] that every
    cycle graph adds its build's report to (_count_build: the builds with
    each flag set, with any, and the largest demand of each kind).  The
    caps stay as configured: `Simulation.run` reads the tally at each
    frame's sync and raises on a build that dropped pairs."""

    def __init__(self, cfg: SimConfig, state: ParticleState,
                 graphs: bool = True):
        self.cfg = cfg
        self.graphs = _graphed(cfg, graphs)
        self._own(*_pad_cycle_state(state, cfg.force_tile))
        self.n, self.mass0 = state.n, state.mass
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.graphs and capturable(self.pos.device) else None)
        self._cycles: dict = {}         # k -> Graphed
        self.tally = _new_tally(self.pos.device)
        self.builds = 0

    def load(self, state: ParticleState) -> None:
        """Start again from `state`, whose padded row count must be the
        loop's."""
        self._load(state)
        self.n, self.mass0 = state.n, state.mass

    def _cycle(self, k: int) -> torch.Tensor:
        """One k-step cycle over the buffers; tallies the build's report
        and returns its overflow flags (build_flags).  k, and with it
        the drift bound's horizon, the hold r and the prediction time
        0.5 (r - 1) dt, is constant for each graph, so baking them in at
        capture is right."""
        cfg = self.cfg
        r = _cycle_hold(cfg, k)
        codes_s, perm, _, _ = sort_by_morton(self.pos, cfg)
        # the gathers allocate: copy them back into the buffers
        self._store(*(x[perm] for x in (self.pos, self.vel, self.mass,
                                         self.acc, self.orig)))
        drift = drift_bound(_norms(self.vel), _norms(self.acc), cfg, k)
        demand = torch.zeros(len(forces.BAND_DEMAND), dtype=torch.int32,
                             device=self.pos.device)
        cells, supers, bands, tables = forces.build_bands(
            self.pos, self.mass, codes_s, cfg, drift=drift, demand=demand)
        tau = 0.5 * (r - 1) * cfg.dt
        for _ in range(k // r):
            afm = forces.apply_farmid(
                hold_predict_pos(self.pos, self.vel, self.acc, tau, cfg),
                supers, tables, cfg)
            for _ in range(r):
                acc = afm + forces.apply_near(self.pos, self.pos, self.mass,
                                              bands, cfg)
                st = integ.integrate(ParticleState(pos=self.pos, vel=self.vel,
                                                   mass=self.mass, acc=acc),
                                     acc, cfg)
                for buf, x in ((self.pos, st.pos), (self.vel, st.vel),
                               (self.acc, acc)):
                    buf.copy_(x)
        flags = build_flags(cells, bands)
        _count_build(self.tally, build_report(flags, cells, demand))
        return flags

    def cycle(self, k: int) -> torch.Tensor:
        """One cycle of k steps, its graph captured on first use; returns
        the build's overflow flags, which the next replay of the same
        graph overwrites."""
        graph = self._cycles.get(k)
        if graph is None:
            graph = self._cycles[k] = Graphed(
                self._cycle, (self.pos, self.vel, self.mass, self.acc,
                              self.orig, self.tally), self.pos.device,
                f"cycle.{k}", self.graphs, self._pool, (k,))
        self.builds += 1
        return graph()


def _run_cycles(loops: dict, cfg: SimConfig, state: ParticleState,
                n_cycles: int, k: int, graphs: bool = True) -> ParticleState:
    """n_cycles k-step cycles from `state` on the cycle loop of `loops`
    (_loop_for): the state after."""
    loop = _loop_for(loops, _CycleLoop, cfg, state, graphs)
    for _ in range(n_cycles):
        loop.cycle(k)
    return loop.snapshot()


def make_cycle_runner(cfg: SimConfig, n_cycles: int, k: int,
                      graphs: bool = True):
    """A function advancing a state by n_cycles * k steps with one band
    rebuild per cycle, skins from the uncapped k-step drift bound.  With
    R = cfg.hold_farmid > 1 dividing k, far+mid is evaluated once per
    R-step sub-cycle at its start positions (per cfg.hold_predict) and
    only the exact near band runs every step; otherwise every step
    evaluates all three bands.  On CUDA a cycle runs as a captured graph
    (unless `graphs` is False), which the function keeps for each padded
    row count it meets and replays in its later calls (_CycleLoop)."""
    loops: dict = {}

    def run(state: ParticleState) -> ParticleState:
        return _run_cycles(loops, cfg, state, n_cycles, k, graphs)

    return run


# ---------------------------------------------------------------------------
# The user-facing Simulation
# ---------------------------------------------------------------------------


class _GraphedStep:
    """`step_fn(state, cfg)` (step_barnes_hut, step_direct, or an
    ensemble's step over [E, ...] fields) over buffers of the state's
    shape: on CUDA, with the hand kernels (_graphed) and unless `graphs`
    is False, one captured graph (utils/graphs.Graphed, named `name`)
    that reads nothing back.  The step reads no acceleration.  A call
    copies the state in and returns copies of the results, which the
    next replay overwrites in the graph's outputs.  With `tally` the step
    is step_barnes_hut's tiled path, and each step adds its build's
    report to the device int64 [16] `tally` (_count_build), counted as
    `builds`."""

    def __init__(self, cfg: SimConfig, state: ParticleState, step_fn,
                 name: str, graphs: bool = True, tally: bool = False):
        self.cfg = cfg
        self._step_fn = step_fn
        self.pos, self.vel, self.mass = (x.clone() for x in state[:3])
        self.tally = _new_tally(state.device) if tally else None
        self.builds = 0
        self._graph = Graphed(self._body, () if self.tally is None
                              else (self.tally,), state.device, name,
                              _graphed(cfg, graphs))

    def _body(self) -> ParticleState:
        st = ParticleState(pos=self.pos, vel=self.vel, mass=self.mass,
                           acc=None)
        if self.tally is None:
            return self._step_fn(st, self.cfg)
        stats: dict = {}
        out = self._step_fn(st, self.cfg, "tiled", stats)
        _count_build(self.tally, stats["report"])
        return out

    def __call__(self, state: ParticleState) -> ParticleState:
        with span("nbody.step"):
            for buf, x in zip((self.pos, self.vel, self.mass), state[:3]):
                buf.copy_(x)
            out = self._graph()
            self.builds += self.tally is not None
            return ParticleState(pos=out.pos.clone(), vel=out.vel.clone(),
                                 mass=state.mass, acc=out.acc.clone())


class Simulation:
    """Owns a config, a device and the step functions.

    method: "barnes_hut" (hand kernels when cfg.use_pallas),
    "barnes_hut_reference" (the per-particle rope walk, rebuilt every
    step) or "direct" (O(N^2)).  `device` defaults to CUDA and raises
    when no GPU is present; pass device="cpu" to run the plain versions
    on the CPU.  `n_rebuilds` counts the adaptive runner's band rebuilds
    over every `run_scan` call, `n_start_rebuilds` those of them that
    began a call (the others ran out a validity horizon), and
    `counters()` reads them with the band builds and overflows of the
    adaptive loops and the fixed-K cycles; `walk_stats` sums the rope
    walk's lockstep iterations and host reads over every reference step.

    On CUDA the per-step rebuild, the direct step, the adaptive runner
    and the fixed-K cycles run as captured CUDA graphs
    (utils/graphs.Graphed), the counterpart of the JAX package's jit
    caches: the Simulation keeps one step graph for each body count, and
    one adaptive loop and one cycle loop (a graph for each cycle length)
    for each padded row count it meets, and replays them in every later
    call, whatever its length.  The rope-walk oracle (host reads by
    design) and the plain sweeps (cfg.use_pallas=False) run eagerly."""

    def __init__(self, cfg: SimConfig, method: str = "barnes_hut",
                 device=None):
        if method not in ("barnes_hut", "barnes_hut_reference", "direct"):
            raise ValueError(f"unknown method {method}")
        self.cfg = cfg
        self.method = method
        self.device = default_device(device)
        self.n_rebuilds = 0
        self.walk_stats = {"iterations": 0, "host_reads": 0}
        # a Simulation has one method, so the step's key leaves it out
        self._steps: dict = {}      # (cfg, n, device) -> _GraphedStep
        self._loops: dict = {}      # (cfg, rows, device) -> _AdaptiveLoop
        self._cycles: dict = {}     # (cfg, rows, device) -> _CycleLoop
        self._overflow_checked = method != "barnes_hut" or not cfg.check_overflow

    def init_state(self) -> ParticleState:
        from nbody_tpu_torch.init import make_initial_state

        return make_initial_state(self.cfg, device=self.device)

    def _check_device(self, state: ParticleState) -> None:
        if state.device.type != self.device.type:
            raise ValueError(f"state lies on {state.device}, the "
                             f"simulation on {self.device}")

    def _step(self, state: ParticleState) -> ParticleState:
        if self.method == "barnes_hut_reference":
            return step_barnes_hut(state, self.cfg, "reference",
                                   self.walk_stats)
        key = (self.cfg, state.n, state.device)
        step = self._steps.get(key)
        if step is None:
            direct = self.method == "direct"
            step = self._steps[key] = _GraphedStep(
                self.cfg, state, step_direct if direct else step_barnes_hut,
                "step", tally=not direct)
        return step(state)

    def step(self, state: ParticleState) -> ParticleState:
        self._check_device(state)
        self._check_overflow(state)
        return self._step(state)

    def run(self, state: ParticleState, n_steps: int,
            callback: Optional[Callable[[int, ParticleState], None]] = None,
            callback_every: int = 0) -> ParticleState:
        """Advance n_steps through `run_scan`; with a callback, in chunks
        of `callback_every` steps, synchronizing the device before each
        call of `callback(steps_done, state)`.  After each chunk's sync
        (without a callback, at the end) the per-step rebuild's and the
        fixed-K cycles' build tallies are read, and a build that dropped
        pairs raises (_check_builds)."""
        chunk = (callback_every if callback is not None and callback_every
                 else n_steps)
        done = 0
        while done < n_steps:
            k = min(chunk, n_steps - done)
            state = self.run_scan(state, k)
            done += k
            if callback is not None and callback_every:
                if state.device.type == "cuda":
                    torch.cuda.synchronize(state.device)
                self._check_builds()
                callback(done, state)
        if callback is None or not callback_every:
            self._check_builds()
        return state

    def run_scan(self, state: ParticleState, n_steps: int) -> ParticleState:
        """Advance n_steps.  The direct method and rebuild_every <= 1 step
        with a full rebuild each; with rebuild_every = K > 1 the adaptive
        runner (cfg.adaptive_rebuild) or fixed-K cycles (K-step cycles,
        then one cycle of the remainder) reuse the bands."""
        with span("nbody.run_scan"):
            self._check_device(state)
            self._check_overflow(state)
            k = self.cfg.rebuild_every
            if self.method != "barnes_hut" or k <= 1:
                for _ in range(n_steps):
                    state = self._step(state)
                return state
            if self.cfg.adaptive_rebuild:
                state, n_rb = _run_adaptive(self._loops, self.cfg, state,
                                            n_steps)
                self.n_rebuilds += n_rb
                return state
            n_cycles, rem = divmod(n_steps, k)
            if n_cycles:
                state = _run_cycles(self._cycles, self.cfg, state, n_cycles,
                                    k)
            if rem:
                state = _run_cycles(self._cycles, self.cfg, state, 1, rem)
            return state

    @property
    def n_start_rebuilds(self) -> int:
        return sum(loop.start_rebuilds for loop in self._loops.values())

    def _tallies(self) -> list:
        """The device tallies (_count_build) of the per-step rebuild and
        the fixed-K cycles, summed (counts) and maxed (demand), read in
        one copy: int [16]."""
        tallies = [x.tally for x in (*self._steps.values(),
                                      *self._cycles.values())
                   if x.tally is not None]
        if not tallies:
            return [0] * (len(BUILD_FLAGS) + 1 + len(DEMANDS))
        if len(tallies) == 1:
            return tallies[0].tolist()
        t = torch.stack(tallies)
        n = len(BUILD_FLAGS) + 1
        return torch.cat([t[:, :n].sum(0), t[:, n:].amax(0)]).tolist()

    def _check_builds(self) -> None:
        """Raise if a per-step or fixed-K cycle build has dropped pairs
        (a flag of BUILD_FLAGS but the grandchild one set), naming the
        demanded caps: those paths keep their caps."""
        if not (self._cycles or any(x.tally is not None
                                    for x in self._steps.values())):
            return
        t = self._tallies()
        flags = dict(zip(BUILD_FLAGS, t[:len(BUILD_FLAGS)]))
        dropped = {k: v for k, v in flags.items() if k in _DROPPING and v}
        if dropped:
            demand = dict(zip(DEMANDS, t[len(BUILD_FLAGS) + 1:]))
            caps = caps_in_force(self.cfg)
            wanted = {k: v for k, v in demand.items() if v > caps[k]}
            raise RuntimeError(
                f"band builds of the per-step rebuild or the fixed-K cycles "
                f"overflowed their caps and dropped pairs (builds by flag "
                f"{dropped}): demanded {wanted}, caps {caps}; raise those "
                "caps in the config")

    def counters(self) -> dict:
        """Counts over every run_scan call: "rebuilds"
        (n_rebuilds), "start_rebuilds" (n_start_rebuilds), "builds" (the
        band builds of the adaptive loops, those redone included, and of
        the fixed-K cycles), "step_builds" (the per-step rebuild's),
        "overflowed_builds" (builds of all three with any flag of
        BUILD_FLAGS set) and "overflow_by_flag" (builds with each flag
        set), "builds_redone" and "cap_growths" (the adaptive loops',
        _AdaptiveLoop), "caps" (the caps in force, by DEMANDS name: the
        largest of the adaptive loops' and the config's) and "demand_max"
        (the largest demand of each kind, of every build).  One host
        read."""
        loops = list(self._loops.values())
        t = self._tallies()
        n = len(BUILD_FLAGS) + 1
        counts, demand = t[:n], t[n:]
        for loop in loops:
            counts = [a + b for a, b in zip(counts, loop.overflows)]
            demand = [max(a, b) for a, b in zip(demand, loop.demand_max)]
        caps = caps_in_force(self.cfg)
        for loop in loops:
            caps = {k: max(v, caps_in_force(loop.cfg)[k])
                    for k, v in caps.items()}
        return {"rebuilds": self.n_rebuilds,
                "start_rebuilds": self.n_start_rebuilds,
                "builds": sum(x.builds + x.builds_redone for x in loops)
                + sum(x.builds for x in self._cycles.values()),
                "step_builds": sum(x.builds for x in self._steps.values()),
                "overflowed_builds": counts[-1],
                "overflow_by_flag": dict(zip(BUILD_FLAGS, counts[:-1])),
                "builds_redone": sum(x.builds_redone for x in loops),
                "cap_growths": sum(x.cap_growths for x in loops),
                "caps": caps,
                "demand_max": dict(zip(DEMANDS, demand))}

    def make_stepper(self, state: ParticleState) -> Optional[AdaptiveStepper]:
        """A persistent stepper for interactive use, or None when the
        config has no reusable band state (direct method, per-step
        rebuilds or fixed-K cycles)."""
        if (self.method == "barnes_hut" and self.cfg.adaptive_rebuild
                and self.cfg.rebuild_every > 1):
            self._check_device(state)
            self._check_overflow(state)
            return AdaptiveStepper(self.cfg, state)
        return None

    def _check_overflow(self, state: ParticleState) -> None:
        """One-time guard on the first step: cell-capacity overflow drops
        whole cells (their mass is missing from every force of the
        per-step rebuild and the fixed-K cycles, and the adaptive runner
        grows the capacity at its first build), so warn loudly;
        grandchild-cap overflow is graceful and warned for tuning.
        cfg.check_overflow=False skips it."""
        if self._overflow_checked:
            return
        self._overflow_checked = True
        with span("nbody.check_overflow"):
            cfg = self.cfg
            cs, perm, lo, size = sort_by_morton(state.pos, cfg)
            ps, ms, csp = forces.pad_sorted(state.pos[perm],
                                            state.mass[perm], cs,
                                            cfg.force_tile)
            cells = build_source_cells(csp, ps, ms, cfg.force_tile, cfg.g,
                                       cfg.cell_capacity, lo, size,
                                       g2_factor=cfg.g2_cap_factor,
                                       bits=cfg.morton_bits)
            if bool(cells.overflow):
                warnings.warn(
                    f"adaptive-cell capacity overflow: n_cells="
                    f"{int(cells.n_cells)} > cell_capacity="
                    f"{cfg.cell_capacity}; truncated cells' mass is MISSING "
                    "from all forces but the adaptive runner's, which grows "
                    "the capacity — raise cfg.cell_cap_factor (now "
                    f"{cfg.cell_cap_factor})",
                    RuntimeWarning, stacklevel=3)
            elif bool(cells.overflow_g2):
                warnings.warn(
                    "grandchild-segment cap overflow (graceful): some "
                    "children take exact P2P instead of grandchild monopoles "
                    f"— raise cfg.g2_cap_factor (now {cfg.g2_cap_factor})",
                    RuntimeWarning, stacklevel=3)
