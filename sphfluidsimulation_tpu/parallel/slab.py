"""True spatial slab decomposition for the site-grid backend.

This is the multi-device tier the reference never had (single GPU,
SURVEY.md §2): the unit cube is cut into z-slabs of
the bucket grid, one per device along mesh axis ``sp``, and each device
owns the particles whose frame-binding voxel falls in its slab. Per-device
memory is O(N/D + halo) for an even split (rows follow the busiest slab),
provable from the array shapes:

* particle rows: ``[C, …]`` with ``C`` = the busiest slab's population
  plus ``(slack − 1) · N/D`` rows of in-flight headroom (``N/D · slack``
  for an even split; :func:`make_spec`);
* site grids:   ``[K, S_loc]`` with ``S_loc = (slab_z + 2·halo) · R²``.

No array of global size N or R³ appears anywhere inside the sharded step.

Why the site-grid formulation decomposes cleanly
------------------------------------------------

The reference's semantic quirk — the candidate bucket is built ONCE per
frame from stale positions while every substep re-reads fresh values
through it (SphFluidSimulation.cs:98-102, VelPos.compute:57-94) — is
exactly what makes slab ownership cheap: keyed by the *stale* cell, a
particle's j-contribution stays on one device for the whole frame. Each
substep therefore needs only

1. a local j-site build over the owned slab (ops/sites.py, slab-local
   grid via ``grid_s``/``member``/``zbase``), and
2. a halo exchange: two ``lax.ppermute`` hops shipping the ``halo``
   boundary z-planes of the j-field stack to the two slab neighbors —
   boundary cells only (NCCL between GPUs).

The i-side (fresh-cell evaluation windows) tolerates drift of up to
``halo − 1`` z-planes past the owned slab; beyond that the evaluation
cell is clamped into the covered band and counted in the exactness
certificate (loud, not wrong).

Particles migrate between slabs at frame boundaries via a bidirectional
ring of ``ppermute`` hops (``D − 1`` hops per direction by default, so any
jump distance is delivered); rows that cannot be placed (row-capacity
overflow) are dropped and counted in ``lost``.

Collectives used: ``ppermute`` (halo + migration), ``psum``/``pmax``
(metrics). There is no all_gather anywhere.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..params import PhysParams
from ..ops import grid, sites
from ..ops.sites import FAR, ISites
from ..sim.stepper import integrate_substep
from ..state import ParticleState, StepMetrics


class SlabState(NamedTuple):
    """Row-buffered particle state, sharded over the slab axis.

    Global leading dim is ``D·C``; device ``d`` holds rows ``[d·C, (d+1)·C)``
    — its slab's particles front-compacted, then invalid padding.
    """

    pos: jax.Array    # f32[D·C, 3]
    vel: jax.Array    # f32[D·C, 3]
    nan_count: jax.Array  # i32[D·C]
    pid: jax.Array    # i32[D·C] — global particle id (reassembly key)
    valid: jax.Array  # bool[D·C]


class SlabSpec(NamedTuple):
    d: int        # devices along the slab axis
    slab_z: int   # owned z-planes per device (= ceil(R / D))
    halo: int     # exchanged boundary planes per side (drift tolerance + 1)
    cap_rows: int # per-device particle row capacity C
    hops: int     # migration ring hops per direction


def make_spec(cfg: SimConfig, n_dev: int, *, halo: int = 2,
              row_slack: float = 2.0, hops: int | None = None,
              busiest: int | None = None) -> SlabSpec:
    """Slab geometry and per-device row capacity.

    Rows per device: the busiest slab's starting population (``busiest``,
    from :func:`slab_populations`; default an even split, ⌈N/D⌉) plus
    ``(row_slack − 1) · ⌈N/D⌉`` rows of headroom for particles arriving
    in flight, at most N. An even split thus gets ``N/D · row_slack``; an
    unbalanced spawn gets the rows its busiest slab needs — the golden
    dam-break's top z-slab owns 54% of 1,048,576 particles at spawn.
    """
    r = cfg.bucket_resolution
    n = cfg.n_particles
    slab_z = -(-r // n_dev)
    halo = min(halo, slab_z)
    if halo < 1:
        raise ValueError("halo must be >= 1")
    even = -(-n // n_dev)
    busiest = even if busiest is None else max(busiest, even)
    cap = min(n, busiest + math.ceil((row_slack - 1.0) * even))
    return SlabSpec(d=n_dev, slab_z=slab_z, halo=halo, cap_rows=cap,
                    hops=n_dev - 1 if hops is None else hops)


def _owner_of(pos_z: jax.Array, r: int, slab_z: int, d: int) -> jax.Array:
    z = jnp.clip((pos_z * (r - 1)).astype(jnp.int32), 0, r - 1)
    return jnp.clip(z // slab_z, 0, d - 1)


# ---------------------------------------------------------------------------
# frame-boundary particle migration (ring ppermute)
# ---------------------------------------------------------------------------


def _compact(order, frows, irows, flag):
    return frows[order], irows[order], flag[order]


def _migrate(frows, irows, valid, my, r, spec: SlabSpec, axis: str):
    """Deliver every valid row to its owner slab via ring hops.

    frows f32[C, Ff] (pos in cols 0:3), irows i32[C, Fi]. Returns
    (frows, irows, valid, lost) — ``lost`` counts rows dropped by
    row-capacity overflow mid-flight plus rows still stranded after all
    hops (never, with hops = D−1 and enough slack).
    """
    c = frows.shape[0]
    iota = lax.iota(jnp.int32, c)

    def one_direction(carry, dirn, perm):
        def hop(carry, _):
            frows, irows, valid, lost = carry
            own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
            want = valid & ((own - my) * dirn > 0)
            # send buffer: want-rows front-compacted (stable by row order)
            _, sorder = lax.sort(((~want).astype(jnp.int32), iota),
                                 num_keys=1, is_stable=True)
            sf, si, sv = _compact(sorder, frows, irows, want)
            rf = lax.ppermute(sf, axis, perm)
            ri = lax.ppermute(si, axis, perm)
            rv = lax.ppermute(sv, axis, perm)  # edge devices: all-False
            # keep-rows front-compacted, received appended
            keep = valid & ~want
            _, korder = lax.sort(((~keep).astype(jnp.int32), iota),
                                 num_keys=1, is_stable=True)
            kf, ki, kv = _compact(korder, frows, irows, keep)
            n_keep = jnp.sum(kv.astype(jnp.int32))
            ridx = jnp.where(rv, n_keep + jnp.cumsum(rv.astype(jnp.int32))
                             - 1, c)
            mf = kf.at[ridx].set(rf, mode="drop")
            mi = ki.at[ridx].set(ri, mode="drop")
            n_recv = jnp.sum(rv.astype(jnp.int32))
            n_tot = n_keep + n_recv
            lost = lost + jnp.maximum(n_tot - c, 0)
            return (mf, mi, iota < jnp.minimum(n_tot, c), lost), None

        return lax.scan(hop, carry, None, length=spec.hops)[0]

    lost0 = jnp.int32(0)
    carry = (frows, irows, valid, lost0)
    if spec.d > 1:
        up = [(i, i + 1) for i in range(spec.d - 1)]
        down = [(i, i - 1) for i in range(1, spec.d)]
        carry = one_direction(carry, +1, up)
        carry = one_direction(carry, -1, down)
    frows, irows, valid, lost = carry
    own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
    stranded = valid & (own != my)
    return (frows, irows, valid & ~stranded,
            lost + jnp.sum(stranded.astype(jnp.int32)))


# ---------------------------------------------------------------------------
# slab-local binding / i-sites / halo exchange
# ---------------------------------------------------------------------------


def _bind_local_capped(pos, pid, valid, my, r, cap, spec: SlabSpec):
    """The frame binding (ops/sites.frame_binding) on one slab's rows.

    Capacity ranks are tie-broken by global particle id (``pid``) — the
    single-device build tie-breaks by row index, and rows arrive here
    migration-permuted, so pid order is what makes the reference's
    capacity drop device-count invariant. Returns (lcid, member, in_cap,
    ovf): slab-local flat cell (sentinel S_loc for non-members), site
    membership, bucket membership, and the capacity/range drop count.
    """
    c = pos.shape[0]
    s_glob = r * r * r
    s_loc = (spec.slab_z + 2 * spec.halo) * r * r
    zbase = my * spec.slab_z - spec.halo
    cell = (pos * (r - 1)).astype(jnp.int32)
    cid = cell[:, 0] + cell[:, 1] * r + cell[:, 2] * (r * r)
    in_range = valid & (cid >= 0) & (cid < s_glob)
    member = in_range
    lcid = jnp.where(member, cid - zbase * (r * r), s_loc)
    if cap is None:
        ovf = jnp.sum(valid & ~in_range).astype(jnp.int32)
        return lcid, member, member, ovf
    key = jnp.where(member, lcid, s_loc)
    sorted_key, _, order = lax.sort((key, pid, lax.iota(jnp.int32, c)),
                                    num_keys=2, is_stable=True)
    run_start = grid.run_starts(sorted_key)
    rank_sorted = lax.iota(jnp.int32, c) - run_start
    rank = jnp.zeros(c, jnp.int32).at[order].set(rank_sorted)
    in_cap = member & (rank < cap)
    ovf = jnp.sum(valid & ~in_cap).astype(jnp.int32)
    return lcid, member, in_cap, ovf


def _build_i_local(pos, vel, rho, pid, valid, my, r, ki, spec: SlabSpec,
                   *, avisc: bool = False) -> ISites:
    """Evaluation sites keyed by the fresh voxel, slab-local.

    The fresh cell may drift past the owned slab; up to ``halo − 1``
    z-planes of drift are covered exactly (the halo'd j-grid spans the
    radius-1 window of the whole band), further drift and out-of-cube
    spawn jitter are clamped into the band and certified.
    """
    c = pos.shape[0]
    zl, hw = spec.slab_z, spec.halo
    s_loc = (zl + 2 * hw) * r * r
    zbase = my * zl - hw
    cell = (pos * (r - 1)).astype(jnp.int32)
    cl = jnp.clip(cell, 0, r - 1)
    jitter = valid & jnp.any(cell != cl, axis=-1)
    lz = cl[:, 2] - zbase
    lz_c = jnp.clip(lz, 1, zl + 2 * hw - 2)
    drift = valid & (lz != lz_c)
    lcid = jnp.where(valid, cl[:, 0] + cl[:, 1] * r + lz_c * (r * r), s_loc)

    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    slot, order = sites._site_slots(keys, lcid, c, s_loc, ki, valid)
    slot_of = jnp.zeros(c, jnp.int32).at[order].set(slot)

    def put(vals_sorted, fill=0.0):
        return (jnp.full(ki * s_loc, fill, jnp.float32)
                .at[slot].set(vals_sorted, mode="drop").reshape(ki, s_loc))

    pos_s = jnp.stack([put(pos[order, a], FAR) for a in range(3)])
    occ = (jnp.zeros(ki * s_loc, jnp.bool_).at[slot]
           .set(True, mode="drop").reshape(ki, s_loc))
    cert = (jnp.sum(valid & (slot_of >= ki * s_loc))
            + jnp.sum(drift) + jnp.sum(jitter)).astype(jnp.int32)
    return ISites(
        pos=pos_s, rho=None if rho is None else put(rho[order]),
        vel=None if not avisc else jnp.stack(
            [put(vel[order, a]) for a in range(3)]),
        delta=jnp.zeros((3, ki, s_loc), jnp.int8), dmax=jnp.int32(0),
        slot_of=slot_of, cert=cert, occ=occ)


def _halo_exchange(jarrs: list[jax.Array], n_pos: int, r: int,
                   spec: SlabSpec, my, axis: str) -> list[jax.Array]:
    """Replace the halo z-planes of the stacked j-fields with the slab
    neighbors' boundary planes (2 × ppermute); domain-edge halos
    get the empty fill (FAR for the first ``n_pos`` position fields)."""
    zl, hw, d = spec.slab_z, spec.halo, spec.d
    ks = [a.shape[0] for a in jarrs]
    x = jnp.concatenate(jarrs, 0).reshape(-1, zl + 2 * hw, r * r)
    fill = jnp.concatenate(
        [jnp.full((k, 1, 1), FAR if f < n_pos else 0.0, jnp.float32)
         for f, k in enumerate(ks)], 0)
    if d > 1:
        up = [(i, i + 1) for i in range(d - 1)]
        down = [(i, i - 1) for i in range(1, d)]
        bot = lax.ppermute(x[:, zl:zl + hw], axis, up)
        top = lax.ppermute(x[:, hw:2 * hw], axis, down)
        bot = jnp.where(my == 0, fill, bot)
        top = jnp.where(my == d - 1, fill, top)
    else:
        shape = x[:, :hw].shape
        bot = top = jnp.broadcast_to(fill, shape)
    x = jnp.concatenate([bot, x[:, hw:hw + zl], top], 1)
    x = x.reshape(-1, (zl + 2 * hw) * r * r)
    out, o = [], 0
    for k in ks:
        out.append(x[o:o + k])
        o += k
    return out


def _exchange_j(j: sites.JSites, r: int, spec: SlabSpec, my,
                axis: str) -> sites.JSites:
    fields = [("pos", 0), ("pos", 1), ("pos", 2)]
    arrs = [j.pos[0], j.pos[1], j.pos[2]]
    for name in ("a", "bp", "dv", "rho", "mult"):
        v = getattr(j, name)
        if v is not None:
            fields.append((name, None))
            arrs.append(v)
    for name in ("cv", "vsum", "vel"):
        v = getattr(j, name)
        if v is not None:
            for a in range(3):
                fields.append((name, a))
                arrs.append(v[a])
    arrs = _halo_exchange(arrs, 3, r, spec, my, axis)
    got: dict = {}
    for (name, comp), arr in zip(fields, arrs):
        if comp is None:
            got[name] = arr
        else:
            got.setdefault(name, [None] * 3)[comp] = arr
    rep = {k: (jnp.stack(v) if isinstance(v, list) else v)
           for k, v in got.items()}
    return j._replace(**rep)


# ---------------------------------------------------------------------------
# the sharded frame step
# ---------------------------------------------------------------------------


def _make_local_step(cfg: SimConfig, spec: SlabSpec, axis: str):
    r = cfg.bucket_resolution
    cap = cfg.voxel_capacity
    kj = cfg.site_capacity
    ki = cfg.site_capacity_i or kj
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    use_x, use_a = xsph != 0.0, alpha != 0.0
    s_loc = (spec.slab_z + 2 * spec.halo) * r * r

    def local_step(pos, vel, nan_count, pid, valid, phys):
        my = lax.axis_index(axis)
        zbase = my * spec.slab_z - spec.halo
        dens_pass = sites.make_density_pass(r, s_loc, 1, zbase=zbase)
        force_pass = sites.make_force_pass(r, s_loc, 1, xsph=xsph,
                                           alpha_visc=alpha, zbase=zbase)

        # -- frame boundary: deliver every particle to its owner slab
        frows = jnp.concatenate([pos, vel], 1)
        irows = jnp.stack([nan_count, pid], 1)
        frows, irows, valid, lost = _migrate(frows, irows, valid, my, r,
                                             spec, axis)
        pos, vel = frows[:, 0:3], frows[:, 3:6]
        nan_count, pid = irows[:, 0], irows[:, 1]

        # -- frame binding + stale density (SphFluidSimulation.cs:98-100)
        lcid, member, in_cap, ovf = _bind_local_capped(pos, pid, valid, my,
                                                       r, cap, spec)
        j0 = sites.build_j_sites(lcid, in_cap, pos, None, None, r, kj,
                                 phys, grid_s=s_loc, member=member)
        j0 = _exchange_j(j0, r, spec, my, axis)
        i0 = _build_i_local(pos, None, None, pid, valid, my, r, ki, spec)
        rho_site = dens_pass(i0, j0, phys)
        rho = sites._gather_site(i0, rho_site, 0.0)
        cert0 = i0.cert + j0.cert + lost

        def substep(carry, _):
            pos, vel, nan_hits, cert = carry
            j = sites.build_j_sites(lcid, in_cap, pos, vel, rho, r, kj,
                                    phys, grid_s=s_loc, member=member,
                                    xsph=use_x, avisc=use_a)
            j = _exchange_j(j, r, spec, my, axis)
            i = _build_i_local(pos, vel if use_a else None, rho, pid,
                               valid, my, r, ki, spec, avisc=use_a)
            sums = force_pass(i, j, phys)
            fstat, vcoef, xstat, xcoef = sites.combine_forces(
                sums, i, phys, xsph=xsph, alpha_visc=alpha)
            f = (jnp.stack([sites._gather_site(i, fstat[a])
                            for a in range(3)], -1)
                 - vel * sites._gather_site(i, vcoef)[:, None])
            dv = None
            if use_x:
                dv = (jnp.stack([sites._gather_site(i, xstat[a])
                                 for a in range(3)], -1)
                      - vel * sites._gather_site(i, xcoef)[:, None])
            f = jnp.where(valid[:, None], f, 0.0)
            pos2, vel2, nan_mask = integrate_substep(pos, vel, f, phys, dv)
            pos2 = jnp.where(valid[:, None], pos2, pos)
            vel2 = jnp.where(valid[:, None], vel2, vel)
            return (pos2, vel2, nan_hits + (nan_mask & valid)
                    .astype(jnp.int32), cert + i.cert + j.cert), None

        nan0 = jnp.zeros(pos.shape[0], jnp.int32)
        (pos, vel, nan_hits, cert), _ = lax.scan(
            substep, (pos, vel, nan0, cert0), None, length=cfg.substeps)
        nan_count = nan_count + nan_hits

        # -- metrics (replicated scalars)
        vmask = valid.astype(jnp.float32)
        speed2 = jnp.sum(vel * vel, -1) * vmask
        n_valid = lax.psum(jnp.sum(vmask), axis)
        m = StepMetrics(
            max_speed=jnp.sqrt(lax.pmax(jnp.max(speed2), axis)),
            mean_density=lax.psum(jnp.sum(rho * vmask), axis)
            / jnp.maximum(n_valid, 1.0),
            kinetic_energy=0.5 * phys.mass * lax.psum(jnp.sum(speed2), axis),
            nan_events=lax.psum(jnp.sum(nan_hits), axis),
            overflow=lax.psum(ovf, axis),
            exact_cert=lax.psum(cert, axis))
        return pos, vel, nan_count, pid, valid, m

    return local_step


def make_slab_step(cfg: SimConfig, mesh: Mesh, *, axis: str = "sp",
                   halo: int = 2, row_slack: float = 2.0,
                   hops: int | None = None, busiest: int | None = None):
    """Sharded faithful frame step ``(SlabState, phys) → (SlabState, m)``.

    All SlabState leaves are sharded ``P(axis)`` on their leading D·C dim.
    Wrap in ``jax.jit``; combine with :func:`distribute`/:func:`collect`
    for global-state entry/exit (host-side, outside the hot loop).
    """
    cfg = cfg.validate()
    spec = make_spec(cfg, mesh.shape[axis], halo=halo, row_slack=row_slack,
                     hops=hops, busiest=busiest)
    local = _make_local_step(cfg, spec, axis)
    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        check_vma=False)

    def step(st: SlabState, phys: PhysParams):
        pos, vel, nan_count, pid, valid, m = shmapped(
            st.pos, st.vel, st.nan_count, st.pid, st.valid, phys)
        return SlabState(pos, vel, nan_count, pid, valid), m

    return step, spec


def make_batched_slab_step(cfg: SimConfig, mesh: Mesh, *,
                           scene_axis: str = "dp", domain_axis: str = "sp",
                           halo: int = 2, row_slack: float = 2.0,
                           hops: int | None = None):
    """2D-parallel step: scene batch over ``scene_axis`` × slabs over
    ``domain_axis``. SlabState leaves are [B, D·C, …] sharded
    P(scene_axis, domain_axis); phys leaves [B] sharded P(scene_axis)."""
    cfg = cfg.validate()
    spec = make_spec(cfg, mesh.shape[domain_axis], halo=halo,
                     row_slack=row_slack, hops=hops)
    local = _make_local_step(cfg, spec, domain_axis)
    vstep = jax.vmap(local, in_axes=(0, 0, 0, 0, 0, 0))
    shmapped = jax.shard_map(
        vstep, mesh=mesh,
        in_specs=(P(scene_axis, domain_axis),) * 5 + (P(scene_axis),),
        out_specs=(P(scene_axis, domain_axis),) * 5 + (P(scene_axis),),
        check_vma=False)

    def step(st: SlabState, phys: PhysParams):
        pos, vel, nan_count, pid, valid, m = shmapped(
            st.pos, st.vel, st.nan_count, st.pid, st.valid, phys)
        return SlabState(pos, vel, nan_count, pid, valid), m

    return step, spec


# ---------------------------------------------------------------------------
# host-side entry / exit
# ---------------------------------------------------------------------------


def slab_populations(state: ParticleState, cfg: SimConfig, n_dev: int):
    """Particles each of ``n_dev`` z-slabs owns in ``state`` (host-side
    numpy ``int64[n_dev]``); its max is :func:`make_spec`'s ``busiest``."""
    import numpy as np

    r = cfg.bucket_resolution
    own = _owner_of(jnp.asarray(state.pos)[:, 2], r, -(-r // n_dev), n_dev)
    return np.bincount(np.asarray(own), minlength=n_dev)


def distribute(state: ParticleState, cfg: SimConfig, spec: SlabSpec,
               mesh: Mesh | None = None, axis: str = "sp") -> SlabState:
    """Global [N] state → slab row buffers (host-side, concrete).

    Raises if any slab's population exceeds the row capacity — give
    :func:`make_spec` the max of :func:`slab_populations` (the in-flight
    equivalent during stepping is the certified ``lost`` counter, never
    an exception).
    """
    import numpy as np

    r = cfg.bucket_resolution
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    nan = np.asarray(state.nan_count)
    n = pos.shape[0]
    own = np.asarray(_owner_of(jnp.asarray(pos[:, 2]), r, spec.slab_z,
                               spec.d))
    c = spec.cap_rows
    buf_pos = np.zeros((spec.d, c, 3), np.float32)
    buf_vel = np.zeros((spec.d, c, 3), np.float32)
    buf_nan = np.zeros((spec.d, c), np.int32)
    buf_pid = np.zeros((spec.d, c), np.int32)
    buf_valid = np.zeros((spec.d, c), bool)
    for d in range(spec.d):
        rows = np.nonzero(own == d)[0]
        if rows.size > c:
            raise ValueError(
                f"slab {d} holds {rows.size} particles > row capacity {c}; "
                f"size the spec from slab_populations")
        buf_pos[d, :rows.size] = pos[rows]
        buf_vel[d, :rows.size] = vel[rows]
        buf_nan[d, :rows.size] = nan[rows]
        buf_pid[d, :rows.size] = rows
        buf_valid[d, :rows.size] = True
    st = SlabState(
        pos=jnp.asarray(buf_pos.reshape(-1, 3)),
        vel=jnp.asarray(buf_vel.reshape(-1, 3)),
        nan_count=jnp.asarray(buf_nan.reshape(-1)),
        pid=jnp.asarray(buf_pid.reshape(-1)),
        valid=jnp.asarray(buf_valid.reshape(-1)))
    if mesh is not None:
        sh = NamedSharding(mesh, P(axis))
        st = jax.tree.map(lambda x: jax.device_put(x, sh), st)
    return st


def collect(st: SlabState, n: int) -> tuple[ParticleState, int]:
    """Slab buffers → global state in particle-id order (host-side).

    Returns (state, n_lost); rows for lost particles (certified drops —
    never in practice) are zero-filled.
    """
    import numpy as np

    valid = np.asarray(st.valid)
    pid = np.asarray(st.pid)[valid]
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    nan = np.zeros(n, np.int32)
    pos[pid] = np.asarray(st.pos)[valid]
    vel[pid] = np.asarray(st.vel)[valid]
    nan[pid] = np.asarray(st.nan_count)[valid]
    return (ParticleState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                          nan_count=jnp.asarray(nan)), n - pid.size)


def make_slab_rollout(cfg: SimConfig, mesh: Mesh, n_frames: int, *,
                      axis: str = "sp", halo: int = 2,
                      row_slack: float = 2.0, hops: int | None = None):
    """Jitted ``(SlabState, phys) → (SlabState, metrics)`` over ``n_frames``
    frames via lax.scan — one device dispatch per rollout, the slab
    analogue of sim.stepper.make_rollout."""
    step, spec = make_slab_step(cfg, mesh, axis=axis, halo=halo,
                                row_slack=row_slack, hops=hops)

    @jax.jit
    def rollout(st: SlabState, phys: PhysParams):
        def body(carry, _):
            st2, m = step(carry, phys)
            return st2, m
        return lax.scan(body, st, None, length=n_frames)

    return rollout, spec
