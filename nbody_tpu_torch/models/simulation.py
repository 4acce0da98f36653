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
cycle, and the per-step and direct steps run as captured CUDA graphs
(utils/graphs.Graphed) over buffers they own, the counterpart of the JAX
package's one jitted program; the host keeps the schedule as integers
and replays the graph each rebuild, cycle or step needs.

Band caps: every band build reports its overflow flags (BUILD_FLAGS) and
what it demands of each capacity (DEMANDS) to its path's BuildTally.  The
adaptive loop also reads each report with its validity horizon and never
sweeps a flagged build: it grows the flagged caps (grown_config, within
cfg.band_budget_gib), captures its graphs again and redoes the build.
The per-step rebuild and the fixed-K cycles keep their caps;
`Simulation.run` raises at a frame's sync on a build that dropped pairs.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Callable, NamedTuple, Optional

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState, default_device
from nbody_tpu_torch.ops import bbox, morton, forces, integrate as integ
from nbody_tpu_torch.ops.cells import CELL_DEMAND, capacity_demand
from nbody_tpu_torch.ops.tree import build_tree
from nbody_tpu_torch.utils.graphs import Graphed, capturable
from nbody_tpu_torch.utils.profiling import span


def sort_by_morton(pos: torch.Tensor, cfg: SimConfig):
    """(codes_sorted int64 [N], perm, lo, size) at cfg.morton_bits."""
    lo, size = bbox.bounding_cube(pos)
    encode = morton.encode63 if cfg.morton_bits == 63 else morton.encode30
    codes_s, perm = morton.morton_sort(encode(pos, lo, size))
    return codes_s, perm, lo, size


def _bh_acc(pos: torch.Tensor, mass: torch.Tensor, cfg: SimConfig,
            force_fn: str, stats: Optional[dict] = None):
    """compute_bh_acc's accelerations and the tiled path's build report
    (_reported_build; None for the rope walk)."""
    if force_fn not in ("tiled", "reference"):
        raise ValueError(f"unknown force_fn {force_fn}")
    n = pos.shape[0]
    codes_s, perm, _, size = sort_by_morton(pos, cfg)
    pos_s, mass_s = pos[perm], mass[perm]
    report = None
    if force_fn == "tiled":
        pos_p, mass_p, codes_p = forces.pad_sorted(pos_s, mass_s, codes_s,
                                                   cfg.force_tile)
        (_, ss, bands, tables), report = _reported_build(pos_p, mass_p,
                                                         codes_p, cfg)
        acc_s = forces.apply_bands(pos_p, mass_p, ss, bands, tables, cfg)[:n]
    else:
        # the tree is 30-bit; a 63-bit key's top 30 bits are a prefix of
        # it, so the sorted order holds for the truncated codes
        codes30 = ((codes_s >> 33) & 0x3FFFFFFF if cfg.morton_bits == 63
                   else codes_s)
        tree = build_tree(codes30, pos_s, mass_s, size)
        acc_s = forces.bh_forces_reference(pos_s, tree, cfg, stats=stats)
    out = torch.empty_like(acc_s)
    out[perm] = acc_s                   # back to the original order
    return out, report


def compute_bh_acc(pos: torch.Tensor, mass: torch.Tensor, cfg: SimConfig,
                   force_fn: str = "tiled",
                   stats: Optional[dict] = None) -> torch.Tensor:
    """Barnes-Hut accelerations in the particles' original order.

    force_fn: "tiled" (the production band decomposition, hand kernels
    when cfg.use_pallas) or "reference" (the per-particle rope walk over
    the escape-linearised tree; `stats` collects its iteration and
    host-read counts)."""
    return _bh_acc(pos, mass, cfg, force_fn, stats)[0]


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
# what a band build demands of each capacity, in the order of its report
# (_reported_build): the band lists and near windows (forces.BAND_DEMAND),
# the cell slots and the grandchild segments (cells.CELL_DEMAND)
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


def _reported_build(pos_s, mass_s, codes_s, cfg: SimConfig, drift=None):
    """build_bands on Morton-sorted, tile-padded inputs (with the skins
    `drift`): (its four results, the build's report), the report an int64
    [15] of BUILD_FLAGS as 0 or 1, then DEMANDS."""
    demand = torch.zeros(len(forces.BAND_DEMAND), dtype=torch.int32,
                         device=pos_s.device)
    built = forces.build_bands(pos_s, mass_s, codes_s, cfg, drift=drift,
                               demand=demand)
    cells, _, bands, _ = built
    return built, torch.cat([build_flags(cells, bands).to(torch.int64),
                             demand.to(torch.int64), capacity_demand(cells)])


class BuildCounts(NamedTuple):
    """Band builds counted on the host, by name: the builds with each flag
    set, those with any set, the largest demand of each kind."""
    by_flag: dict
    overflowed: int
    demand_max: dict

    def dropped(self) -> dict:
        """The set flags that dropped pairs (_DROPPING), with counts."""
        return {f: v for f, v in self.by_flag.items() if f in _DROPPING and v}


class BuildTally:
    """Band builds' reports (_reported_build) tallied on the device in an
    int64 [16] `counts`: [0:7] the builds with each flag set, [7] those
    with any set, [8:16] the largest demand of each kind.  `add` needs no
    host read, so a captured graph counts at every replay."""

    _N = len(BUILD_FLAGS)

    def __init__(self, device):
        self.counts = torch.zeros(self._N + 1 + len(DEMANDS),
                                  dtype=torch.int64, device=device)

    def add(self, report: torch.Tensor) -> None:
        n, flags, c = self._N, report[:self._N], self.counts
        c[:n].add_(flags)
        c[n:n + 1].add_(flags.amax())
        torch.maximum(c[n + 1:], report[n:], out=c[n + 1:])

    @classmethod
    def read(cls, tallies) -> BuildCounts:
        """The tallies of `tallies` but None in one host copy (none without
        a tally): the counts summed, the demands maxed."""
        tallies = [x for x in tallies if x is not None]
        n, t = cls._N, [0] * (cls._N + 1 + len(DEMANDS))
        if tallies:
            s = torch.stack([x.counts for x in tallies])
            t = torch.cat([s[:, :n + 1].sum(0), s[:, n + 1:].amax(0)]).tolist()
        return BuildCounts(dict(zip(BUILD_FLAGS, t[:n])), t[n],
                           dict(zip(DEMANDS, t[n + 1:])))


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
    when it spans rebuilds), self-tuned skins, the reported band build
    and the validity horizon.

    rebuild(pos, vel, mass, acc, orig, k_env, afm=None) returns
    (fields, built, (s_valid, report)): fields = (pos, vel, mass, acc,
    orig, afm) in the new order (afm None when not given), built =
    (cells, supers, bands, tables, rctx), build_bands' four results and
    what refresh_farmid needs, the validity horizon (a device int64
    scalar) and the build's report (_reported_build).  It writes nothing
    back: the caller picks the next envelope horizon."""

    def rebuild(pos, vel, mass, acc, orig, k_env, afm=None):
        codes_s, perm, box_lo, size = sort_by_morton(pos, cfg)
        pos, vel, mass, acc, orig = (pos[perm], vel[perm], mass[perm],
                                     acc[perm], orig[perm])
        if afm is not None:
            afm = afm[perm]
        v, a = _norms(vel), _norms(acc)
        drift = adaptive_drift(v, a, codes_s, size, cfg,
                               k=k_env.to(torch.float32))
        built, report = _reported_build(pos, mass, codes_s, cfg, drift)
        s_valid = validity_horizon(v, a, drift, cfg)
        # what refresh_farmid needs to recompute moments at this cut
        rctx = (codes_s, drift, box_lo, size)
        return ((pos, vel, mass, acc, orig, afm), (*built, rctx),
                (s_valid, report))

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

    def load(self, state: ParticleState) -> None:
        """Start again from `state` of the loop's padded row count."""
        fields = _pad_cycle_state(state, self.cfg.force_tile)
        if fields[0].shape != self.pos.shape:
            raise ValueError(f"{state.n} bodies pad to {fields[0].shape[0]} "
                             f"rows, the loop has {self.pos.shape[0]}")
        self._store(*fields)
        self.n, self.mass0 = state.n, state.mass

    def _store(self, pos, vel, mass, acc, orig) -> None:
        for buf, x in zip((self.pos, self.vel, self.mass, self.acc,
                           self.orig), (pos, vel, mass, acc, orig)):
            buf.copy_(x)

    def _near(self, bands) -> torch.Tensor:
        return forces.apply_near(self.pos, self.pos, self.mass, bands,
                                 self.cfg)

    def _near_step(self, afm: torch.Tensor, bands) -> None:
        """One step over the buffers: `afm` + the near band of `bands`."""
        acc = afm + self._near(bands)
        st = integ.integrate(ParticleState(self.pos, self.vel, self.mass,
                                           acc), acc, self.cfg)
        for buf, x in zip((self.pos, self.vel, self.acc), (st.pos, st.vel,
                                                            acc)):
            buf.copy_(x)

    def snapshot(self) -> ParticleState:
        with span("nbody.loop.snapshot"):
            return _unpad(self.pos, self.vel, self.acc, self.orig, self.n,
                          self.mass0)


class _AdaptiveLoop(_PaddedLoop):
    """The adaptive schedule as a host loop, one `step()` per step.

    A rebuild happens when the current structure's validity horizon is
    used up; it reads s_valid and the build's report in one copy (the one
    host sync of a rebuild), and s_valid sets the horizon, the next
    envelope horizon k_env = clip(2 s_valid, 1, K) and, with
    cfg.span_age_mult, the hold limit r_eff = clip(span_age_mult *
    s_valid, 1, R).  Every other decision is taken from host integers, so
    an inner step (far+mid refresh or not, with or without
    refresh_moments, exact near, integrate) reads nothing back.

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

    The loop owns its buffers: the padded fields, the held far+mid (afm),
    the envelope horizon k_env and the refresh's prediction time tau (0-d,
    float64).  The rebuild and each kind of inner step (no refresh, a
    refresh from the frozen moments, a refresh that recomputes them) read
    and write only buffers, and the inner steps the rebuild's live outputs
    (`built`), so on CUDA each is one captured graph (utils/graphs.Graphed)
    unless `graphs` is False or the config has no hand kernels (_graphed).
    `load` starts again from a state of the same padded row count, reusing
    the graphs and the caps; `carry` goes on from where the last step
    left the loop, which is right only for the state `snapshot` last
    returned, unchanged (`carries`).  Both keep the counters: `builds`
    (rebuilds), `start_rebuilds` (the first after each load or
    construction; the others ran out a horizon), `carried_calls` (the
    carries), `builds_redone` (flagged builds, thrown away),
    `cap_growths` (one a cap each time it grows), `first_build` (the
    first build's BuildCounts, from its read) and `tally`, the BuildTally
    that the rebuild graph adds every build to, redone ones included.
    `n_rebuilds` counts the rebuilds since the last load or carry.

    The schedule is shared with the multi-device loop
    (parallel/shard.py), which overrides the rebuild (`_build`), the
    moment refresh, the near band and the snapshot, and runs eagerly;
    its rebuild counts no build and grows no cap."""

    def __init__(self, cfg: SimConfig, state: ParticleState,
                 graphs: bool = True):
        self._start(cfg, state.n, state.mass,
                    *_pad_cycle_state(state, cfg.force_tile),
                    graphs=_graphed(cfg, graphs))
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
        self.tally = BuildTally(dev)
        self.first_build = None
        self.builds = self.start_rebuilds = self.carried_calls = 0
        self.builds_redone = self.cap_growths = 0
        self._graphs_on = graphs
        self._make_steps()
        self.n, self.mass0 = n, mass0
        self._reset()

    def _make_steps(self) -> None:
        """The inner-step graphs, in a new memory pool that the rebuild
        graph shares: the loop's graphs replay one at a time on one stream
        and keep their results in the buffers or their live outputs."""
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
                            self.orig, self.afm, self.k_env,
                            self.tally.counts),
                       self.pos.device, name, self._graphs_on, self._pool,
                       args)

    def _reset(self) -> None:
        # fills, not copies from the host (which would synchronize)
        self.k_env.fill_(self.cfg.rebuild_every)
        self.afm.zero_()
        # span: the age starts at R, so the very first step refreshes
        self.afm_age = self.r if self.span else 0
        self.left = 0          # steps the current structure stays valid
        self.j = 0             # steps since the last rebuild
        self.r_eff = self.r
        self.n_rebuilds = 0
        self._fresh = True     # the next rebuild is a start rebuild
        self._handed = None    # the last snapshot's tensors (weak), versions

    def load(self, state: ParticleState) -> None:
        """Start again from `state`, with k_env, the held far+mid and the
        host counters as a new loop has them: one state, one run."""
        super().load(state)
        self._reset()

    def snapshot(self) -> ParticleState:
        out = super().snapshot()
        self._handed = tuple((weakref.ref(x), x._version) for x in out)
        return out

    def carries(self, state: ParticleState) -> bool:
        """Whether `state` is what `snapshot` last returned, unchanged:
        the same pos, vel, mass and acc tensors, none written in place
        since (their version counters), and the loop neither stepped nor
        loaded since.  The tensors are held weakly: a state the caller
        let go is never carried."""
        return self._handed is not None and all(
            ref() is x and x._version == version
            for (ref, version), x in zip(self._handed, state))

    def carry(self) -> None:
        """Go on from where the last step left the buffers, k_env, the
        held far+mid and its age, the built structure and its countdown:
        the steps that follow are those one longer run would take.  Only
        n_rebuilds starts again, at 0."""
        self.carried_calls += 1
        self.n_rebuilds = 0

    def _rebuild_body(self):
        """The rebuild over the buffers: the fields (and the held far+mid
        when it spans rebuilds) in the new order, the build's report added
        to the tally; returns (built, [s_valid, report])."""
        fields, built, (s_valid, report) = self._rebuild_fn(
            self.pos, self.vel, self.mass, self.acc, self.orig, self.k_env,
            self.afm if self.span else None)
        self._store(*fields[:5])
        if self.span:
            self.afm.copy_(fields[5])
        self.tally.add(report)
        return built, torch.cat([s_valid.reshape(1), report])

    def _build_once(self):
        """One build at the loop's caps: (s_valid, flags, demand), read
        in one copy."""
        self.built, report = self._rebuild_graph()
        with span("nbody.rebuild.horizon_read"):
            r = report.tolist()
        flags, demand = r[1:1 + len(BUILD_FLAGS)], r[1 + len(BUILD_FLAGS):]
        if self.first_build is None:
            self.first_build = BuildCounts(dict(zip(BUILD_FLAGS, flags)),
                                           max(flags),
                                           dict(zip(DEMANDS, demand)))
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
        self.start_rebuilds += self._fresh
        self._fresh = False
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

    def _inner(self, refresh: Optional[str]) -> None:
        """One inner step over the buffers.  With `refresh` ("farmid":
        from the frozen moments, "refreshed": every moment recomputed)
        far+mid is evaluated afresh at the positions hold_predict samples
        `tau` ahead; then the near band and the integration."""
        if refresh is not None:
            p_mid = hold_predict_pos(self.pos, self.vel, self.acc, self.tau,
                                     self.cfg)
            self.afm.copy_(self._farmid_refreshed(p_mid)
                           if refresh == "refreshed" else self._farmid(p_mid))
        self._near_step(self.afm, self.built[2])

    def step(self) -> None:
        cfg = self.cfg
        self._handed = None
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
    count and device, made on first use (its graphs captured as it meets
    them).  An adaptive loop handed its own last output unchanged
    (_AdaptiveLoop.carries) goes on from it; any other loop is loaded
    with `state`."""
    rows = -(-state.n // cfg.force_tile) * cfg.force_tile
    key = (cfg, rows, state.device)
    with span("nbody.loop.load"):
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = kind(cfg, state, graphs)
        elif isinstance(loop, _AdaptiveLoop) and loop.carries(state):
            loop.carry()
        else:
            loop.load(state)
    return loop


def _run_adaptive(loops: dict, cfg: SimConfig, state: ParticleState,
                  n_steps: int, graphs: bool = True):
    """n_steps of the adaptive schedule from `state` on the adaptive
    loop of `loops` (_loop_for), starting with a rebuild unless the loop
    carries the state: (the state after, the number of rebuilds)."""
    loop = _loop_for(loops, _AdaptiveLoop, cfg, state, graphs)
    for _ in range(n_steps):
        loop.step()
    return loop.snapshot(), loop.n_rebuilds


def make_adaptive_runner(cfg: SimConfig, n_steps: int,
                         return_stats: bool = False, graphs: bool = True):
    """A function advancing a state by n_steps with adaptive,
    step-granular band rebuilds (cfg.adaptive_rebuild).  Each rebuild
    gives every particle the envelope min(v dt K safety, skin_width_cap *
    local cell width) and reuses the structure for exactly its validity
    horizon, so the hot core falls back to per-step rebuilds while calm
    epochs coast for ~K steps.  A call on the function's own last
    output, unchanged, goes on with the schedule where the last call
    left it, so a chain of calls equals one call of all their steps bit
    for bit; a call on any other state starts with a rebuild at k_env =
    K.  With return_stats it returns (state, the call's rebuilds).  Its
    adaptive loops (_AdaptiveLoop), one a padded row count, keep their
    graphs (none with `graphs` False) across calls."""
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
    frame rebuilds only when the physics demands it, with no snapshot
    between calls (`run_scan` carries its schedule across calls too, but
    hands back a state in the original order every call).  The first
    rebuild happens here.  The stepper's loop keeps its captured graphs
    (on CUDA) across calls."""

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
    captured graph (utils/graphs.Graphed; _graphed), replayed for every
    cycle of that length; the graphs keep their results in the buffers
    and share one pool.  `load` (_PaddedLoop.load) reuses the graphs and
    keeps the counters `builds` (cycles run) and `tally`, the BuildTally
    that every cycle adds its build to.  The caps stay as configured:
    `Simulation.run` reads the tally at each frame's sync."""

    def __init__(self, cfg: SimConfig, state: ParticleState,
                 graphs: bool = True):
        self.cfg = cfg
        self.graphs = _graphed(cfg, graphs)
        self._own(*_pad_cycle_state(state, cfg.force_tile))
        self.n, self.mass0 = state.n, state.mass
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.graphs and capturable(self.pos.device) else None)
        self._cycles: dict = {}         # k -> Graphed
        self.tally = BuildTally(self.pos.device)
        self.builds = 0

    def _cycle(self, k: int) -> torch.Tensor:
        """One k-step cycle over the buffers; tallies the build and returns
        its flags (build_flags).  k, and with it the drift bound's horizon,
        the hold r and the prediction time 0.5 (r - 1) dt, is constant for
        each graph, so baking them in at capture is right."""
        cfg = self.cfg
        r = _cycle_hold(cfg, k)
        codes_s, perm, _, _ = sort_by_morton(self.pos, cfg)
        # the gathers allocate: copy them back into the buffers
        self._store(*(x[perm] for x in (self.pos, self.vel, self.mass,
                                         self.acc, self.orig)))
        drift = drift_bound(_norms(self.vel), _norms(self.acc), cfg, k)
        (_, supers, bands, tables), report = _reported_build(
            self.pos, self.mass, codes_s, cfg, drift)
        tau = 0.5 * (r - 1) * cfg.dt
        for _ in range(k // r):
            afm = forces.apply_farmid(
                hold_predict_pos(self.pos, self.vel, self.acc, tau, cfg),
                supers, tables, cfg)
            for _ in range(r):
                self._near_step(afm, bands)
        self.tally.add(report)
        return report[:len(BUILD_FLAGS)].bool()

    def cycle(self, k: int) -> torch.Tensor:
        """One cycle of k steps, its graph captured on first use: the
        build's flags, which the next replay of that graph overwrites."""
        graph = self._cycles.get(k)
        if graph is None:
            graph = self._cycles[k] = Graphed(
                self._cycle, (self.pos, self.vel, self.mass, self.acc,
                              self.orig, self.tally.counts), self.pos.device,
                f"cycle.{k}", self.graphs, self._pool, (k,))
        self.builds += 1
        return graph()


def make_cycle_runner(cfg: SimConfig, n_cycles: int, k: int,
                      graphs: bool = True):
    """A function advancing a state by n_cycles * k steps with one band
    rebuild per cycle, skins from the uncapped k-step drift bound.  With
    R = cfg.hold_farmid > 1 dividing k, far+mid is evaluated once per
    R-step sub-cycle at its start positions (per cfg.hold_predict) and
    only the exact near band runs every step; otherwise every step
    evaluates all three bands.  Its cycle loops (_CycleLoop), one a padded
    row count, keep their graphs (none with `graphs` False) across calls."""
    loops: dict = {}

    def run(state: ParticleState) -> ParticleState:
        loop = _loop_for(loops, _CycleLoop, cfg, state, graphs)
        for _ in range(n_cycles):
            loop.cycle(k)
        return loop.snapshot()

    return run


# ---------------------------------------------------------------------------
# The user-facing Simulation
# ---------------------------------------------------------------------------


class _GraphedStep:
    """`step_fn(state, cfg)` (step_direct, or an ensemble's step over
    [E, ...] fields) over buffers of the state's shape, or with `tally`
    step_barnes_hut's tiled path, each step adding its build to the
    BuildTally `tally` and counted as `builds`: on CUDA one captured graph
    (utils/graphs.Graphed, named `name`; _graphed) that reads nothing
    back.  The step reads no acceleration.  A call copies the state in
    and returns copies of the results, which the next replay overwrites."""

    def __init__(self, cfg: SimConfig, state: ParticleState, step_fn,
                 name: str, graphs: bool = True, tally: bool = False):
        self.cfg = cfg
        self._step_fn = step_fn
        self.pos, self.vel, self.mass = (x.clone() for x in state[:3])
        self.tally = BuildTally(state.device) if tally else None
        self.builds = 0
        self._graph = Graphed(self._body, () if self.tally is None
                              else (self.tally.counts,), state.device, name,
                              _graphed(cfg, graphs))

    def _body(self) -> ParticleState:
        st = ParticleState(self.pos, self.vel, self.mass, None)
        if self.tally is None:
            return self._step_fn(st, self.cfg)
        acc, report = _bh_acc(self.pos, self.mass, self.cfg, "tiled")
        self.tally.add(report)
        return integ.integrate(st, acc, self.cfg)

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
    over every `run_scan` call, `n_start_rebuilds` those that began a
    call the runner did not carry; `counters()` reads them, the carried
    calls and the band builds of every path;
    `walk_stats` sums the rope walk's lockstep iterations and host reads.

    The Simulation keeps one step graph for each body count, and one
    adaptive loop and one cycle loop for each padded row count it meets
    (utils/graphs.Graphed on CUDA, the counterpart of the JAX package's
    jit caches), and replays them in every later call, whatever its
    length.  The rope-walk oracle and the plain sweeps run eagerly."""

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
        state = step(state)
        self._check_overflow(lambda: BuildTally.read([step.tally]))
        return state

    def step(self, state: ParticleState) -> ParticleState:
        self._check_device(state)
        return self._step(state)

    def run(self, state: ParticleState, n_steps: int,
            callback: Optional[Callable[[int, ParticleState], None]] = None,
            callback_every: int = 0) -> ParticleState:
        """Advance n_steps through `run_scan`; with a callback, in chunks
        of `callback_every` steps, synchronizing the device before each
        call of `callback(steps_done, state)`.  After each chunk's sync
        (without a callback, at the end) a build that dropped pairs raises
        (_check_builds)."""
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
        then one cycle of the remainder) reuse the bands.

        The adaptive runner given the state its last call returned, with
        no tensor of it replaced or written in place, goes on where that
        call stopped (_AdaptiveLoop.carries): the same structure, envelope
        horizon k_env and held far+mid, so a chain of calls on their own
        outputs equals one call of all their steps bit for bit, however
        the steps are split.  Any other state (a copy, one changed in
        place, another Simulation's, or an older output) starts with a
        rebuild at k_env = K."""
        with span("nbody.run_scan"):
            self._check_device(state)
            k = self.cfg.rebuild_every
            if self.method != "barnes_hut" or k <= 1:
                for _ in range(n_steps):
                    state = self._step(state)
                return state
            if self.cfg.adaptive_rebuild:
                loop = _loop_for(self._loops, _AdaptiveLoop, self.cfg, state,
                                 True)
                for _ in range(n_steps):
                    loop.step()
                self.n_rebuilds += loop.n_rebuilds
                if loop.first_build is not None:
                    self._check_overflow(lambda: loop.first_build)
                return loop.snapshot()
            n_cycles, rem = divmod(n_steps, k)
            for count, length in ((n_cycles, k), (int(rem > 0), rem)):
                if count:
                    loop = _loop_for(self._cycles, _CycleLoop, self.cfg,
                                     state, True)
                    for _ in range(count):
                        loop.cycle(length)
                        self._check_overflow(
                            lambda: BuildTally.read([loop.tally]))
                    state = loop.snapshot()
            return state

    @property
    def n_start_rebuilds(self) -> int:
        return sum(loop.start_rebuilds for loop in self._loops.values())

    def _check_builds(self) -> None:
        """Raise if a per-step or fixed-K cycle build dropped pairs
        (BuildCounts.dropped), naming the demanded caps: those paths keep
        their caps."""
        c = BuildTally.read(x.tally for x in (*self._steps.values(),
                                              *self._cycles.values()))
        dropped = c.dropped()
        if dropped:
            caps = caps_in_force(self.cfg)
            wanted = {k: v for k, v in c.demand_max.items() if v > caps[k]}
            raise RuntimeError(
                f"band builds of the per-step rebuild or the fixed-K cycles "
                f"overflowed their caps and dropped pairs (builds by flag "
                f"{dropped}): demanded {wanted}, caps {caps}; raise those "
                "caps in the config")

    def counters(self) -> dict:
        """Counts over every call, one host read: "rebuilds" and
        "start_rebuilds" (n_rebuilds, n_start_rebuilds), "carried_calls"
        (the adaptive runner's calls that went on from their state without
        a start rebuild), "builds" (the
        adaptive loops', redone ones included, and the fixed-K cycles'),
        "step_builds" (the per-step rebuild's), from every path's
        BuildTally "overflowed_builds", "overflow_by_flag" and
        "demand_max", the adaptive loops' "builds_redone" and
        "cap_growths", and "caps" (the largest in force, by DEMANDS)."""
        loops = list(self._loops.values())
        c = BuildTally.read(x.tally for x in (*self._steps.values(),
                                              *self._cycles.values(), *loops))
        caps = {k: max(caps_in_force(cfg)[k] for cfg in (self.cfg, *(
            x.cfg for x in loops))) for k in DEMANDS}
        return {"rebuilds": self.n_rebuilds,
                "start_rebuilds": self.n_start_rebuilds,
                "carried_calls": sum(x.carried_calls for x in loops),
                "builds": sum(x.builds + x.builds_redone for x in loops)
                + sum(x.builds for x in self._cycles.values()),
                "step_builds": sum(x.builds for x in self._steps.values()),
                "overflowed_builds": c.overflowed,
                "overflow_by_flag": c.by_flag,
                "builds_redone": sum(x.builds_redone for x in loops),
                "cap_growths": sum(x.cap_growths for x in loops),
                "caps": caps,
                "demand_max": c.demand_max}

    def make_stepper(self, state: ParticleState) -> Optional[AdaptiveStepper]:
        """A persistent stepper for interactive use, or None when the
        config has no reusable band state (direct method, per-step
        rebuilds or fixed-K cycles)."""
        if (self.method == "barnes_hut" and self.cfg.adaptive_rebuild
                and self.cfg.rebuild_every > 1):
            self._check_device(state)
            stepper = AdaptiveStepper(self.cfg, state)
            self._check_overflow(lambda: stepper._loop.first_build)
            return stepper
        return None

    def _check_overflow(self, first: Callable[[], BuildCounts]) -> None:
        """Warn once, after the Simulation's first band build, from its
        counts `first()` (the adaptive loop's read, or one host read of the
        per-step or cycle tally that holds it alone): of dropped cells
        loudly, of a graceful grandchild overflow for tuning."""
        if self._overflow_checked:
            return
        self._overflow_checked = True
        with span("nbody.check_overflow"):
            c, cfg = first(), self.cfg
            if c.by_flag["cells"]:      # its demand: the cut's cell count
                warnings.warn(
                    f"adaptive-cell capacity overflow: n_cells="
                    f"{c.demand_max['cells']} > cell_capacity="
                    f"{cfg.cell_capacity}; truncated cells' mass is MISSING "
                    "from all forces but the adaptive runner's, which grows "
                    "the capacity — raise cfg.cell_cap_factor (now "
                    f"{cfg.cell_cap_factor})",
                    RuntimeWarning, stacklevel=3)
            elif c.by_flag["g2"]:
                warnings.warn(
                    "grandchild-segment cap overflow (graceful): some "
                    "children take exact P2P instead of grandchild monopoles "
                    f"— raise cfg.g2_cap_factor (now {cfg.g2_cap_factor})",
                    RuntimeWarning, stacklevel=3)
