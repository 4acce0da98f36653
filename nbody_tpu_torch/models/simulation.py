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
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.state import ParticleState, default_device
from nbody_tpu_torch.ops import bbox, morton, forces, integrate as integ
from nbody_tpu_torch.ops.cells import build_source_cells
from nbody_tpu_torch.ops.tree import build_tree


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
    when cfg.use_pallas) or "reference" (the per-particle rope walk over
    the escape-linearised tree; `stats` collects its iteration and
    host-read counts)."""
    if force_fn not in ("tiled", "reference"):
        raise ValueError(f"unknown force_fn {force_fn}")
    n = pos.shape[0]
    codes_s, perm, _, size = sort_by_morton(pos, cfg)
    pos_s, mass_s = pos[perm], mass[perm]
    if force_fn == "tiled":
        pos_p, mass_p, codes_p = forces.pad_sorted(pos_s, mass_s, codes_s,
                                                   cfg.force_tile)
        acc_s = forces.bh_forces_grouped(pos_p, mass_p, codes_p, cfg)[:n]
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
    prediction measured harmful in the contracted core."""
    if cfg.hold_predict == 0:
        return pos
    p = pos + vel * tau
    if cfg.hold_predict >= 2:
        p = p + acc * (0.5 * tau * tau)
    return p


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=1))


def _adaptive_rebuild_fn(cfg: SimConfig):
    """One adaptive band rebuild: Morton re-sort, the permutation applied
    to every per-particle field (and to the held far+mid acceleration
    when it spans rebuilds), self-tuned skin envelopes, band build,
    validity horizon and envelope feedback.

    rebuild(pos, vel, mass, acc, orig, k_env, afm=None) returns
    (fields, built, (s_valid, k_next)) with fields = (pos, vel, mass,
    acc, orig, afm) in the new order (afm None when not given), built =
    (cells, supers, bands, tables, rctx), build_bands' four results and
    what refresh_farmid needs, and the two device scalars:
      * s_valid: the validity horizon;
      * k_next: the next envelope horizon, ~2 s_valid (calm epochs grow
        back to K in a few rebuilds), halved instead when this build's
        skins overflowed any band cap (a standing theta violation for
        the overflowed pairs)."""

    def rebuild(pos, vel, mass, acc, orig, k_env, afm=None):
        codes_s, perm, box_lo, size = sort_by_morton(pos, cfg)
        pos, vel, mass, acc, orig = (pos[perm], vel[perm], mass[perm],
                                     acc[perm], orig[perm])
        if afm is not None:
            afm = afm[perm]
        v, a = _norms(vel), _norms(acc)
        drift = adaptive_drift(v, a, codes_s, size, cfg,
                               k=k_env.to(torch.float32))
        cells, supers, bands, tables = forces.build_bands(pos, mass, codes_s,
                                                          cfg, drift=drift)
        s_valid = validity_horizon(v, a, drift, cfg)
        overflowed = (bands.ss_overflow | bands.sup_overflow
                      | bands.mid_overflow | bands.cmid_overflow
                      | bands.near_overflow)
        k_next = torch.where(overflowed, torch.clamp(k_env // 2, min=1),
                             torch.clamp(2 * s_valid, 1, cfg.rebuild_every))
        # what refresh_farmid needs to recompute moments at this cut
        rctx = (codes_s, drift, box_lo, size)
        return ((pos, vel, mass, acc, orig, afm),
                (cells, supers, bands, tables, rctx), (s_valid, k_next))

    return rebuild


class _AdaptiveLoop:
    """The adaptive schedule as a host loop, one `step()` per step.

    A rebuild happens when the current structure's validity horizon is
    used up; it reads s_valid once (the one host sync of a rebuild: the
    band build works at the static caps and reads nothing), and that
    integer sets the horizon and, with cfg.span_age_mult, the hold limit
    r_eff = clip(span_age_mult * s_valid, 1, R).  Every other decision is
    taken from host integers, so an inner step (far+mid refresh or not,
    with or without refresh_moments, exact near, integrate) reads nothing
    back from the device.

    The held far+mid is refreshed on the first step after a rebuild and
    every R steps; with cfg.farmid_span_rebuilds it is permuted along
    with the rebuild and only its age (limit r_eff) refreshes it.  With
    cfg.refresh_moments a refresh that is not the first step after a
    rebuild recomputes every source moment from live positions at the
    frozen cut (forces.refresh_farmid)."""

    def __init__(self, cfg: SimConfig, state: ParticleState):
        self.cfg = cfg
        self.r = max(1, cfg.hold_farmid)
        self.span = cfg.farmid_span_rebuilds
        self._rebuild_fn = _adaptive_rebuild_fn(cfg)
        self.n = state.n
        self.mass0 = state.mass
        (self.pos, self.vel, self.mass, self.acc,
         self.orig) = _pad_cycle_state(state, cfg.force_tile)
        # a fill, not a copy from the host (which would synchronize)
        self.k_env = torch.full((), cfg.rebuild_every, device=state.device)
        self.afm = torch.zeros_like(self.pos)
        # span: the age starts at R, so the very first step refreshes
        self.afm_age = self.r if self.span else 0
        self.left = 0          # steps the current structure stays valid
        self.j = 0             # steps since the last rebuild
        self.r_eff = self.r
        self.n_rebuilds = 0
        self.built = None

    def rebuild(self) -> None:
        fields, self.built, (s_valid_t, self.k_env) = self._rebuild_fn(
            self.pos, self.vel, self.mass, self.acc, self.orig, self.k_env,
            self.afm if self.span else None)
        self.pos, self.vel, self.mass, self.acc, self.orig, afm = fields
        if self.span:
            self.afm = afm
        s_valid = int(s_valid_t.item())            # the one host read
        self.left, self.j = s_valid, 0
        self.n_rebuilds += 1
        if self.span and self.cfg.span_age_mult > 0:
            self.r_eff = min(max(self.cfg.span_age_mult * s_valid, 1), self.r)

    def step(self) -> None:
        cfg = self.cfg
        if self.left <= 0:
            self.rebuild()
        _, supers, bands, tables, rctx = self.built
        if self.span:
            refresh = self.afm_age >= self.r_eff
        else:
            refresh = self.j == 0 or self.afm_age >= self.r
        if refresh:
            tau = 0.5 * (self.r_eff - 1) * cfg.dt
            p_mid = hold_predict_pos(self.pos, self.vel, self.acc, tau, cfg)
            if cfg.refresh_moments and self.j > 0:
                self.afm = forces.refresh_farmid(self.pos, self.mass, *rctx,
                                                 bands, cfg, tgt_pos=p_mid)
            else:
                self.afm = forces.apply_farmid(p_mid, supers, tables, cfg)
            self.afm_age = 1
        else:
            self.afm_age += 1
        a = self.afm + forces.apply_near(self.pos, self.pos, self.mass, bands,
                                         cfg)
        st = integ.integrate(ParticleState(pos=self.pos, vel=self.vel,
                                           mass=self.mass, acc=a), a, cfg)
        self.pos, self.vel, self.acc = st.pos, st.vel, st.acc
        self.left -= 1
        self.j += 1

    def snapshot(self) -> ParticleState:
        return _unpad(self.pos, self.vel, self.acc, self.orig, self.n,
                      self.mass0)


def make_adaptive_runner(cfg: SimConfig, n_steps: int,
                         return_stats: bool = False):
    """A function advancing a state by n_steps with adaptive,
    step-granular band rebuilds (cfg.adaptive_rebuild), starting with a
    rebuild.  Each rebuild gives every particle the envelope
    min(v dt K safety, skin_width_cap * local cell width) and reuses the
    structure for exactly its validity horizon, so the hot core falls
    back to per-step rebuilds while calm epochs coast for ~K steps.
    With return_stats it returns (state, number of rebuilds)."""

    def run(state: ParticleState):
        loop = _AdaptiveLoop(cfg, state)
        for _ in range(n_steps):
            loop.step()
        out = loop.snapshot()
        return (out, loop.n_rebuilds) if return_stats else out

    return run


class AdaptiveStepper:
    """The adaptive runner's schedule split at host-call boundaries, for
    interactive use: positions in Morton order, the frozen band
    structures, the validity countdown and the held far+mid stay on the
    device across `advance` calls, so a viewer stepping a few steps per
    frame rebuilds only when the physics demands it (`run_scan` starts
    every call with a rebuild).  The first rebuild happens here."""

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
        clones of the last particle (enough for rendering)."""
        return self._loop.pos

    @property
    def vel_sorted(self) -> torch.Tensor:
        return self._loop.vel

    def snapshot(self) -> ParticleState:
        """The full state in the original particle order."""
        return self._loop.snapshot()


def make_cycle_runner(cfg: SimConfig, n_cycles: int, k: int):
    """A function advancing a state by n_cycles * k steps with one band
    rebuild per cycle, skins from the uncapped k-step drift bound.  With
    R = cfg.hold_farmid > 1 dividing k, far+mid is evaluated once per
    R-step sub-cycle at its start positions (per cfg.hold_predict) and
    only the exact near band runs every step; otherwise every step
    evaluates all three bands."""
    r = max(1, cfg.hold_farmid)
    if k % r:
        r = 1                 # the hold must divide the cycle

    def run(state: ParticleState) -> ParticleState:
        pos, vel, mass, acc, orig = _pad_cycle_state(state, cfg.force_tile)
        for _ in range(n_cycles):
            codes_s, perm, _, _ = sort_by_morton(pos, cfg)
            pos, vel, mass, acc, orig = (pos[perm], vel[perm], mass[perm],
                                         acc[perm], orig[perm])
            drift = drift_bound(_norms(vel), _norms(acc), cfg, k)
            _, supers, bands, tables = forces.build_bands(
                pos, mass, codes_s, cfg, drift=drift)
            for _ in range(k // r):
                p_mid = hold_predict_pos(pos, vel, acc, 0.5 * (r - 1) * cfg.dt,
                                         cfg)
                afm = forces.apply_farmid(p_mid, supers, tables, cfg)
                for _ in range(r):
                    acc = afm + forces.apply_near(pos, pos, mass, bands, cfg)
                    st = integ.integrate(ParticleState(pos=pos, vel=vel,
                                                       mass=mass, acc=acc),
                                         acc, cfg)
                    pos, vel = st.pos, st.vel
        return _unpad(pos, vel, acc, orig, state.n, state.mass)

    return run


# ---------------------------------------------------------------------------
# The user-facing Simulation
# ---------------------------------------------------------------------------


class Simulation:
    """Owns a config, a device and the step functions.

    method: "barnes_hut" (hand kernels when cfg.use_pallas),
    "barnes_hut_reference" (the per-particle rope walk, rebuilt every
    step) or "direct" (O(N^2)).  `device` defaults to CUDA and raises
    when no GPU is present; pass device="cpu" to run the plain versions
    on the CPU.  `n_rebuilds` counts the adaptive runner's band rebuilds
    over every `run_scan` call; `walk_stats` sums the rope walk's
    lockstep iterations and host reads over every reference step."""

    def __init__(self, cfg: SimConfig, method: str = "barnes_hut",
                 device=None):
        if method not in ("barnes_hut", "barnes_hut_reference", "direct"):
            raise ValueError(f"unknown method {method}")
        self.cfg = cfg
        self.method = method
        self.device = default_device(device)
        self.n_rebuilds = 0
        self.walk_stats = {"iterations": 0, "host_reads": 0}
        self._overflow_checked = method != "barnes_hut" or not cfg.check_overflow

    def init_state(self) -> ParticleState:
        from nbody_tpu_torch.init import make_initial_state

        return make_initial_state(self.cfg, device=self.device)

    def _check_device(self, state: ParticleState) -> None:
        if state.device.type != self.device.type:
            raise ValueError(f"state lies on {state.device}, the "
                             f"simulation on {self.device}")

    def _step(self, state: ParticleState) -> ParticleState:
        if self.method == "direct":
            return step_direct(state, self.cfg)
        if self.method == "barnes_hut_reference":
            return step_barnes_hut(state, self.cfg, "reference",
                                   self.walk_stats)
        return step_barnes_hut(state, self.cfg)

    def step(self, state: ParticleState) -> ParticleState:
        self._check_device(state)
        self._check_overflow(state)
        return self._step(state)

    def run(self, state: ParticleState, n_steps: int,
            callback: Optional[Callable[[int, ParticleState], None]] = None,
            callback_every: int = 0) -> ParticleState:
        """Advance n_steps through `run_scan`; with a callback, in chunks
        of `callback_every` steps, synchronizing the device before each
        call of `callback(steps_done, state)`."""
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
                callback(done, state)
        return state

    def run_scan(self, state: ParticleState, n_steps: int) -> ParticleState:
        """Advance n_steps.  The direct method and rebuild_every <= 1 step
        with a full rebuild each; with rebuild_every = K > 1 the adaptive
        runner (cfg.adaptive_rebuild) or fixed-K cycles (K-step cycles,
        then one cycle of the remainder) reuse the bands."""
        self._check_device(state)
        self._check_overflow(state)
        k = self.cfg.rebuild_every
        if self.method != "barnes_hut" or k <= 1:
            for _ in range(n_steps):
                state = self._step(state)
            return state
        if self.cfg.adaptive_rebuild:
            state, n_rb = make_adaptive_runner(self.cfg, n_steps,
                                               return_stats=True)(state)
            self.n_rebuilds += n_rb
            return state
        n_cycles, rem = divmod(n_steps, k)
        if n_cycles:
            state = make_cycle_runner(self.cfg, n_cycles, k)(state)
        if rem:
            state = make_cycle_runner(self.cfg, 1, rem)(state)
        return state

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
        whole cells (their mass is missing from every force), so warn
        loudly; grandchild-cap overflow is graceful and warned for
        tuning.  cfg.check_overflow=False skips it."""
        if self._overflow_checked:
            return
        self._overflow_checked = True
        cfg = self.cfg
        cs, perm, lo, size = sort_by_morton(state.pos, cfg)
        ps, ms, csp = forces.pad_sorted(state.pos[perm], state.mass[perm], cs,
                                        cfg.force_tile)
        cells = build_source_cells(csp, ps, ms, cfg.force_tile, cfg.g,
                                   cfg.cell_capacity, lo, size,
                                   g2_factor=cfg.g2_cap_factor,
                                   bits=cfg.morton_bits)
        if bool(cells.overflow):
            warnings.warn(
                f"adaptive-cell capacity overflow: n_cells="
                f"{int(cells.n_cells)} > cell_capacity={cfg.cell_capacity}; "
                "truncated cells' mass is MISSING from all forces — raise "
                f"cfg.cell_cap_factor (now {cfg.cell_cap_factor})",
                RuntimeWarning, stacklevel=3)
        elif bool(cells.overflow_g2):
            warnings.warn(
                "grandchild-segment cap overflow (graceful): some children "
                "take exact P2P instead of grandchild monopoles — raise "
                f"cfg.g2_cap_factor (now {cfg.g2_cap_factor})",
                RuntimeWarning, stacklevel=3)
