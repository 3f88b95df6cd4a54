"""Site-grid SPH backend — the exactness / decomposition tier.

It is fresh-centered by construction, exact on explosive scenes, and its
dense slab-local grids drive the multi-device decomposition in
parallel/slab.py. Its cost scales with the grid (R³ cells × site
capacity²), not with the particles; PERF.md has its H100 times.

The reference walks, per particle, a 27-voxel window of a dense bucket table
(Density.compute:42-57, VelPos.compute:67-98). This backend removes *all*
gathers from the hot path by storing candidates in a dense voxel-slot grid,

    field[k, c]   slot k < K, flat cell c = x + y·R + z·R²   (k-major),

so the candidates of cell ``c`` at window offset ``(ox,oy,oz)`` live at
``field[:, c + ox + oy·R + oz·R²]`` — a *uniform shift* of the whole array
(cells are x-minor, the reference's own flat-id rule, Bucket.compute:28).
The 27-cell gather becomes 27 shifted slices of a padded array, and the
pair interaction between every i-slot and every j-slot is one dense
broadcast ``[Ki,1,S] × [1,Kj,S]`` that XLA fuses into dense elementwise
loops.

Sites, not particles
--------------------

Slots hold *sites* — groups of particles sharing (cell, position[, ρ]) —
not individual particles. This matters because the reference's clamp
(VelPos.compute:154) parks fast particles at exactly coincident wall/corner
points: measured golden-scene voxels hold up to ~39k coincident particles,
which no per-particle slot capacity survives. Coincident particles collapse
to ONE site carrying a multiplicity and a velocity sum, exactly because
every pair term is either position-only or *linear in the velocities*:

    density   ρ(x)       = m Σ_s mult_s · W(x − x_s)
    pressure  f_p(x,ρ,p) = m²/ρ · Σ_s (p + p_s) mult_s/(2ρ_s) ∇W(x − x_s)
    viscosity f_v(x,ρ,v) = μm²/ρ · [Σ_s (ΣV)_s/ρ_s ∇²W  −  v Σ_s mult_s/ρ_s ∇²W]

so per-site sums U,W,B,C evaluated on the grid combine with per-particle
(ρ_i, p_i, v_i) afterwards — bit-faithful to the reference's per-pair loop
(fp products by small integer multiplicities are exactly the iterated sums,
and the reference's 32-per-voxel candidate cap bounds mult ≤ 32).

Exactness under the reference's stale-bucket semantics
------------------------------------------------------

The reference builds the bucket once per frame but re-centers each window
on the particle's *fresh* cell every substep and reads *fresh* positions
and velocities through the stale candidate lists (VelPos.compute:57-58,
86-94). Both grids are therefore rebuilt every substep:

* the j-grid keys sites by their frame-stale flat cell id (including the
  reference's x-wrap aliasing) but carries fresh positions/velocities, and
  gates membership by the frame-start capacity flag — the stale bucket
  with fresh values, exactly;
* the i-grid keys evaluation sites by the fresh cell, so the 27-offset
  window IS the reference's fresh-centered window — no drift correction
  needed, for any speed. The only correction is at spawn (frame 1), where
  jittered positions may sit outside the unit cube before the first clamp:
  the i-cell is clamped into range and a per-site δ ∈ {−1,0,1} widens the
  scan to radius 2 with an ``|off − δ| ≤ 1`` gate (lax.switch, taken only
  while max|δ| > 0).

Empty slots and padded margins encode position FAR=2.0: every kernel
vanishes identically at r ≥ h, so empties contribute exactly zero without
occupancy masks. Site-capacity overflow (more than K distinct positions in
one voxel) is surfaced in the exactness certificate; the capacity is a
config knob (SimConfig.site_capacity).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import EPSILON
from ..params import PhysParams
from . import grid

_PI = math.pi
FAR = 2.0  # empty-slot position: ≥ 1+h from any in-cube point ⇒ kernels ≡ 0


# ---------------------------------------------------------------------------
# frame binding (the reference's once-per-frame bucket insert)
# ---------------------------------------------------------------------------


def frame_binding(pos: jax.Array, r: int, cap: int | None):
    """Frame-start bucket membership per particle.

    Returns (stale_cid i32[N], in_cap bool[N], overflow i32[]). ``stale_cid``
    is the flat voxel id with the reference's aliasing arithmetic
    (Bucket.compute:27-28); ``in_cap`` marks particles that made it into the
    reference's bucket (rank < cap within their voxel, deterministic
    stable-sort ranks replacing the reference's atomic race, and in-range
    flat id — out-of-range UAV writes are dropped silently by D3D11).
    ``cap=None`` disables the capacity drop entirely (truly uncapped).
    """
    n = pos.shape[0]
    s = r * r * r
    cell = (pos * (r - 1)).astype(jnp.int32)          # trunc = HLSL int3 cast
    cid = cell[..., 0] + cell[..., 1] * r + cell[..., 2] * (r * r)
    in_range = (cid >= 0) & (cid < s)
    if cap is None:
        ovf = jnp.sum(~in_range).astype(jnp.int32)
        return cid, in_range, ovf
    iota = lax.iota(jnp.int32, n)
    sorted_cid, order = lax.sort((cid, iota), num_keys=1, is_stable=True)
    run_start = grid.run_starts(sorted_cid)
    rank_sorted = iota - run_start
    rank = jnp.zeros(n, jnp.int32).at[order].set(rank_sorted)
    in_cap = in_range & (rank < cap)
    ovf = jnp.sum(~in_cap).astype(jnp.int32)
    return cid, in_cap, ovf


# ---------------------------------------------------------------------------
# site builds
# ---------------------------------------------------------------------------


class JSites(NamedTuple):
    """Per-substep candidate grid: the stale bucket carrying fresh values,
    deduplicated into sites. All [Kj, S] (f32 unless noted)."""

    pos: jax.Array        # [3, Kj, S] fresh site position; empty FAR
    a: jax.Array          # mult/(2ρ) pressure weight (ρ>ε guard folded);
                          # in the rho=None density build: the raw mult
    bp: jax.Array | None  # p·mult/(2ρ)
    cv: jax.Array | None  # [3, Kj, S] ΣV/ρ — viscosity velocity sum
    dv: jax.Array | None  # mult/ρ
    rho: jax.Array | None    # stale ρ (xsph/avisc only)
    mult: jax.Array | None   # site multiplicity (xsph/avisc only)
    vsum: jax.Array | None   # [3, Kj, S] ΣV (xsph only)
    vel: jax.Array | None    # [3, Kj, S] per-site velocity (avisc only)
    cert: jax.Array       # i32[] bucket candidates dropped (capacity/alias)


class ISites(NamedTuple):
    """Per-substep evaluation grid: unique fresh (position, ρ) sites keyed
    by the fresh voxel. All [Ki, S]."""

    pos: jax.Array        # [3, Ki, S]; empty FAR
    rho: jax.Array | None # stale ρ per site (None for the density pass)
    vel: jax.Array | None # per-site velocity (avisc only)
    delta: jax.Array      # i8[3, Ki, S] true fresh cell − clamped cell
    dmax: jax.Array       # i32[] max |delta| (0 after the first clamp)
    slot_of: jax.Array    # i32[N] flat site index; sentinel Ki·S if dropped
    cert: jax.Array       # i32[] particles with no evaluation site
    occ: jax.Array        # bool[Ki, S]


def _site_slots(keys: list[jax.Array], cid: jax.Array, n: int, s: int,
                k: int, in_range: jax.Array | None):
    """Shared dedup machinery: stable sort by (cid[, member], *keys), site
    ranks within each voxel, per-particle slot index (k·S + cid layout,
    sentinel k·S). Returns (slot i32[N] sorted-order, order i32[N]).

    When a member mask is given, members sort AHEAD of non-members within
    each voxel so their site ranks never count ghost sites — capacity is
    spent on contributing rows only.
    """
    iota = lax.iota(jnp.int32, n)
    if in_range is None:
        sort_keys = [cid, *keys]
    else:
        sort_keys = [cid, (~in_range).astype(jnp.int32), *keys]
    ops = lax.sort((*sort_keys, iota), num_keys=len(sort_keys),
                   is_stable=True)
    sorted_cid, *sorted_keys, order = ops
    new = jnp.zeros(n, jnp.bool_).at[0].set(True)
    for sk in sorted_keys:
        new = new | jnp.concatenate([jnp.ones(1, jnp.bool_),
                                     sk[1:] != sk[:-1]])
    new = new | jnp.concatenate([jnp.ones(1, jnp.bool_),
                                 sorted_cid[1:] != sorted_cid[:-1]])
    g = jnp.cumsum(new.astype(jnp.int32)) - 1          # global site ordinal
    run_start = grid.run_starts(sorted_cid)
    site_rank = g - g[run_start]
    ok = site_rank < k
    if in_range is None:
        ok = ok & (sorted_cid >= 0) & (sorted_cid < s)
    else:
        ok = ok & in_range[order]
    slot = jnp.where(ok, site_rank * s + jnp.clip(sorted_cid, 0, s - 1),
                     k * s)
    return slot, order


def build_j_sites(stale_cid: jax.Array, in_cap: jax.Array, pos: jax.Array,
                  vel: jax.Array | None, rho: jax.Array | None, r: int,
                  kj: int, p: PhysParams, *, xsph: bool = False,
                  avisc: bool = False, grid_s: int | None = None,
                  member: jax.Array | None = None,
                  cert_member: jax.Array | None = None) -> JSites:
    """The stale bucket re-expressed with fresh values, as sites.

    Site key: (stale flat cell, fresh position[, stale ρ][, fresh vel when
    avisc]); only ``in_cap`` members count toward multiplicity and velocity
    sums (the reference's ≤32 candidates per voxel, VelPos.compute:77-81).
    ``rho=None`` builds the position-only grid for the density pass.

    ``grid_s``/``member`` support slab-local grids (parallel/slab.py) and
    z-banded grids (``density_sites``/``fluid_forces_sites`` with
    ``z_bands > 1``): ``stale_cid`` is then local, the grid spans
    ``grid_s`` cells, and ``member`` restricts the rows allowed to occupy
    sites (owned + valid / in-band + halo). In every case slot competition
    is additionally gated on ``in_cap`` — capacity-dropped rows carry zero
    weight in all fields, so excluding them is exact and keeps
    kj == voxel_capacity sufficient.

    ``cert_member`` restricts which capacity-dropped rows the certificate
    counts (banded grids overlap on halo planes; each voxel's drops must
    be counted by exactly one band — its interior owner). None keeps the
    full count.
    """
    n = pos.shape[0]
    s = grid_s if grid_s is not None else r * r * r
    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    # site membership is gated on in_cap: rows dropped by the reference's
    # bucket cap carry zero weight in EVERY field, so excluding them from
    # slot competition is exact and guarantees kj == voxel_capacity always
    # suffices (in-cap candidates per voxel <= cap >= distinct sites)
    ms = in_cap if member is None else (member & in_cap)
    slot, order = _site_slots(keys, stale_cid, n, s, kj, ms)

    w = in_cap[order].astype(jnp.float32)

    def put(vals_sorted, fill=0.0):
        return (jnp.full(kj * s, fill, jnp.float32)
                .at[slot].set(vals_sorted, mode="drop").reshape(kj, s))

    def add(vals_sorted):
        return (jnp.zeros(kj * s, jnp.float32)
                .at[slot].add(vals_sorted, mode="drop").reshape(kj, s))

    pos_s = jnp.stack([put(pos[order, a], FAR) for a in range(3)])
    mult = add(w)
    vsum = (None if vel is None
            else jnp.stack([add(vel[order, a] * w) for a in range(3)]))
    # reference candidates that found no site slot (capacity overflow)
    wc = w if cert_member is None else (in_cap & cert_member)[order].astype(
        jnp.float32)
    cert = jnp.sum(jnp.where(slot >= kj * s, wc, 0.0)).astype(jnp.int32)

    if rho is None:
        return JSites(pos=pos_s, a=mult, bp=None, cv=None, dv=None,
                      rho=None, mult=None, vsum=None, vel=None, cert=cert)

    rho_s = put(rho[order])
    press = p.gas_constant * (rho_s - p.rest_density)
    irho2 = jnp.where(rho_s > EPSILON, 0.5 / jnp.maximum(rho_s, EPSILON),
                      0.0)
    a = mult * irho2
    return JSites(
        pos=pos_s, a=a, bp=press * a, cv=vsum * (2.0 * irho2),
        dv=mult * (2.0 * irho2),
        rho=rho_s if (xsph or avisc) else None,
        mult=mult if xsph else None,
        vsum=vsum if xsph else None,
        vel=jnp.stack([put(vel[order, a2]) for a2 in range(3)])
        if avisc else None,
        cert=cert)


def build_i_sites(pos: jax.Array, vel: jax.Array | None,
                  rho: jax.Array | None, r: int, ki: int, *,
                  avisc: bool = False, grid_s: int | None = None,
                  zbase: jax.Array | int = 0,
                  member: jax.Array | None = None) -> ISites:
    """Evaluation sites keyed by the fresh voxel (clamped into range; the
    out-of-range remainder δ widens the window — spawn jitter only).

    ``grid_s``/``zbase``/``member`` build a z-band-local grid instead
    (cells ``[zbase·R², zbase·R² + grid_s)`` of the global id space):
    only ``member`` rows compete for sites or count toward the
    certificate; the others read the sentinel slot."""
    n = pos.shape[0]
    s = grid_s if grid_s is not None else r * r * r
    cell = (pos * (r - 1)).astype(jnp.int32)
    clamped = jnp.clip(cell, 0, r - 1)
    cid = clamped[..., 0] + clamped[..., 1] * r + clamped[..., 2] * (r * r)
    if grid_s is not None:
        cid = cid - jnp.int32(zbase) * (r * r)
    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    mem = jnp.ones(n, jnp.bool_) if member is None else member
    slot, order = _site_slots(keys, cid, n, s, ki, mem)
    slot_of = jnp.zeros(n, jnp.int32).at[order].set(slot)

    def put(vals_sorted, fill=0.0):
        return (jnp.full(ki * s, fill, jnp.float32)
                .at[slot].set(vals_sorted, mode="drop").reshape(ki, s))

    pos_s = jnp.stack([put(pos[order, a], FAR) for a in range(3)])
    occ = (jnp.zeros(ki * s, jnp.bool_).at[slot].set(True, mode="drop")
           .reshape(ki, s))
    d = (cell - clamped).astype(jnp.int32)
    delta = jnp.stack([
        (jnp.zeros(ki * s, jnp.int32)
         .at[slot].set(d[order, a], mode="drop").reshape(ki, s))
        for a in range(3)])
    dmax = jnp.max(jnp.abs(delta)).astype(jnp.int32)
    # certificate: particles with no evaluation site (capacity) or beyond
    # the widest compiled window's δ coverage (spawn overshoot > 2 cells);
    # band-local builds count their own members only
    cert = (jnp.sum((slot >= ki * s) & mem[order])
            + jnp.sum((jnp.max(jnp.abs(d), axis=-1) > 2) & mem)
            ).astype(jnp.int32)
    return ISites(
        pos=pos_s, rho=None if rho is None else put(rho[order]),
        vel=None if not avisc else jnp.stack(
            [put(vel[order, a]) for a in range(3)]),
        delta=delta, dmax=dmax, slot_of=slot_of, cert=cert, occ=occ)


# ---------------------------------------------------------------------------
# pair passes (shifted-slice window scans)
# ---------------------------------------------------------------------------


def _pad(arr: jax.Array, pad: int, fill: float) -> jax.Array:
    return jnp.pad(arr, ((0, 0), (pad, pad)), constant_values=fill)


def _cell_coords(r: int, s: int, zbase=0):
    """Global (x, y, z) coordinates of the flat ids [0, s). ``zbase`` maps a
    slab-local grid back to global z (it may be a traced scalar inside
    shard_map); ``s`` need not be r³ — any whole number of z-planes works."""
    c = lax.iota(jnp.int32, s)
    return c % r, (c // r) % r, c // (r * r) + zbase


def _gate(r: int, s: int, oz, oy: int, ox: int, delta, zbase=0):
    """Bounds check (Density.compute:46) and — when a nonzero δ exists —
    fresh-window membership |off − δ| ≤ 1 (VelPos.compute:57-58). Bool:
    callers SELECT on it (jnp.where) rather than multiply — 0 * inf = NaN
    would leak NaN into the sums from out-of-bounds windows the reference
    never evaluates."""
    cx, cy, cz = _cell_coords(r, s, zbase)
    b = ((cx + ox >= 0) & (cx + ox < r) & (cy + oy >= 0) & (cy + oy < r)
         & (cz + oz >= 0) & (cz + oz < r))[None, :]
    if delta is not None:
        b = b & ((jnp.abs(ox - delta[0]) <= 1)
                 & (jnp.abs(oy - delta[1]) <= 1)
                 & (jnp.abs(oz - delta[2]) <= 1))
    return b


def _kj_scanned(body, kj: int):
    """Fold ``body`` over the j-slot axis one slot at a time.

    The dense pair broadcast materializes [Ki, Kj, S] temporaries —
    432 MB per temp at 1M particles (Ki=Kj=16, S=75³), several per offset.
    Scanning Kj keeps every temp at [Ki, 1, S] with identical flops; the
    bodies already broadcast over the j axis, so a [1, S] slice flows
    through them unchanged. Summation order over j-slots
    changes (slot-by-slot instead of one axis reduction) — float-order
    only, the candidate SET is identical.
    """

    def scanned(acc, jsl, oz, oy, ox):
        def step(acc, k):
            jslk = [lax.dynamic_slice_in_dim(a, k, 1, axis=0) for a in jsl]
            return body(acc, jslk, oz, oy, ox), None

        return lax.scan(step, acc, jnp.arange(kj))[0]

    return scanned


# Above this grid size the dense [Ki, Kj, S] pair broadcast's temporaries
# outgrow HBM headroom; the j-slot axis is scanned instead (no flop change).
KJ_SCAN_CELLS = 1 << 16


def _window_scan(jarrs: list[jax.Array], r: int, s: int, w: int,
                 body, acc0):
    """Offset-window sweep: ``body(acc, jslices, oz, oy, ox)`` consumes one
    window offset's shifted j-slices [K, S].

    ``jarrs`` are [K, S] j-side arrays (first 3 = positions, padded FAR so
    out-of-array reads vanish through the kernels; the rest padded 0).

    Radius 1 (the steady-state hot path) unrolls the (oy,ox) plane
    statically inside a z-offset lax.scan, so XLA fuses the 9 shifted
    slices per z step into one VPU loop. Wider radii (spawn frames only)
    scan a flat offset list with one dynamic slice per offset — small
    compiled code for a cold path.
    """
    if s > KJ_SCAN_CELLS:
        body = _kj_scanned(body, jarrs[0].shape[0])
    pad = w * (r * r + r + 1)
    m = w * (r + 1)
    padded = ([_pad(a, pad, FAR) for a in jarrs[:3]]
              + [_pad(a, pad, 0.0) for a in jarrs[3:]])

    if w == 1:
        def dz_body(acc, oz):
            start = pad + oz * (r * r) - m
            wins = [lax.dynamic_slice(f, (jnp.int32(0), start),
                                      (f.shape[0], s + 2 * m))
                    for f in padded]
            for oy in range(-w, w + 1):
                for ox in range(-w, w + 1):
                    o = m + oy * r + ox
                    jsl = [wf[:, o:o + s] for wf in wins]
                    acc = body(acc, jsl, oz, oy, ox)
            return acc, None

        acc, _ = lax.scan(dz_body, acc0, jnp.arange(-w, w + 1))
        return acc

    span = jnp.arange(-w, w + 1)
    offs = jnp.stack(jnp.meshgrid(span, span, span,
                                  indexing="ij"), -1).reshape(-1, 3)

    def off_body(acc, off):
        oz, oy, ox = off[0], off[1], off[2]
        start = pad + oz * (r * r) + oy * r + ox
        jsl = [lax.dynamic_slice(f, (jnp.int32(0), start),
                                 (f.shape[0], s)) for f in padded]
        return body(acc, jsl, oz, oy, ox), None

    acc, _ = lax.scan(off_body, acc0, offs)
    return acc


def make_density_pass(r: int, s: int, w: int, zbase=0):
    """ρ per i-site (Density.compute:32-60; self term included via the
    site's own multiplicity at offset 0). ``s``/``zbase`` may describe a
    slab-local grid (parallel/slab.py)."""

    def run(i: ISites, j: JSites, p: PhysParams):
        h2, h9 = p.h * p.h, p.h ** 9
        ki = i.pos.shape[1]
        ipx = i.pos[0][:, None, :]
        ipy = i.pos[1][:, None, :]
        ipz = i.pos[2][:, None, :]
        delta = i.delta if w > 1 else None

        def body(acc, jsl, oz, oy, ox):
            dx = ipx - jsl[0][None]
            dy = ipy - jsl[1][None]
            dz = ipz - jsl[2][None]
            diff = h2 - (dx * dx + dy * dy + dz * dz)
            wk = jnp.where(diff > 0, diff * diff * diff, 0.0)
            g = _gate(r, s, oz, oy, ox, delta, zbase)
            return acc + jnp.where(g, jnp.sum(wk * jsl[3][None], axis=1),
                                   0.0)

        acc0 = jnp.zeros((ki, s), jnp.float32)
        # j arrays: pos(3), mult (rides JSites.a in the rho=None build)
        acc = _window_scan([j.pos[0], j.pos[1], j.pos[2], j.a], r, s, w,
                           body, acc0)
        c6 = 315.0 / (64.0 * _PI)
        return acc * (p.mass * c6 / h9)

    return run


def make_force_pass(r: int, s: int, w: int, *, xsph: float = 0.0,
                    alpha_visc: float = 0.0, zbase=0):
    """Per-i-site force field sums (VelPos.compute:49-105) + extensions.

    Accumulates, per i-site:

        pa⃗ = Σ  mult_j/(2ρ_j) ∇W_p           (× p_i · c_p · m²/ρ_i later)
        pb⃗ = Σ  p_j mult_j/(2ρ_j) ∇W_p       (× c_p · m²/ρ_i later)
        vb⃗ = Σ  (ΣV)_j/ρ_j · ∇²W_v profile   (× c_v · μm²/ρ_i later)
        vc  = Σ  mult_j/ρ_j · ∇²W_v profile   (× v_i · same scale later)
        av⃗ = Σ  Π_sj mult_j ∇W_p             (× c_p · m² later, avisc)
        xv⃗ = Σ  2m/(ρ_i+ρ_j) W (ΣV)_j        (xsph)
        xm  = Σ  2m/(ρ_i+ρ_j) W mult_j       (× v_i, xsph)

    with ∇W_p profile (h−r)³/r (VelPos:33-38), ∇²W_v profile (h−r)
    (VelPos:40-44), constants applied in the combine step. Returns a dict.
    """
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0

    def run(i: ISites, j: JSites, p: PhysParams):
        h2 = p.h * p.h
        ki = i.pos.shape[1]
        ip = [i.pos[a][:, None, :] for a in range(3)]
        delta = i.delta if w > 1 else None
        irho = None if i.rho is None else i.rho[:, None, :]
        ivel = None if i.vel is None else [i.vel[a][:, None, :]
                                           for a in range(3)]
        cs = jnp.sqrt(p.gas_constant)

        names = ["px", "py", "pz", "a", "bp", "cvx", "cvy", "cvz", "dv"]
        jarrs = [j.pos[0], j.pos[1], j.pos[2],
                 j.a, j.bp, j.cv[0], j.cv[1], j.cv[2], j.dv]
        if use_a:
            names += ["rho", "vx", "vy", "vz", "mult"]
            jarrs += [j.rho, j.vel[0], j.vel[1], j.vel[2], j.mult]
        if use_x:
            if "rho" not in names:
                names += ["rho"]
                jarrs += [j.rho]
            names += ["xmult", "vsx", "vsy", "vsz"]
            jarrs += [j.mult, j.vsum[0], j.vsum[1], j.vsum[2]]

        out_names = (["pax", "pay", "paz", "pbx", "pby", "pbz",
                      "vbx", "vby", "vbz", "vc"]
                     + (["avx", "avy", "avz"] if use_a else [])
                     + (["xvx", "xvy", "xvz", "xm"] if use_x else []))
        acc0 = {k: jnp.zeros((ki, s), jnp.float32) for k in out_names}

        def body(acc, jsl, oz, oy, ox):
            jf = {k: v[None] for k, v in zip(names, jsl)}
            dx = ip[0] - jf["px"]
            dy = ip[1] - jf["py"]
            dz = ip[2] - jf["pz"]
            d3 = (dx, dy, dz)
            r2 = dx * dx + dy * dy + dz * dz
            abs_r = jnp.sqrt(r2)
            diff = p.h - abs_r
            valid = (diff > EPSILON) & (abs_r > EPSILON)
            safe = jnp.where(valid, abs_r, 1.0)
            gwp = jnp.where(valid, (diff * diff * diff) / safe, 0.0)
            gwv = jnp.where(abs_r < p.h, diff, 0.0)
            g = _gate(r, s, oz, oy, ox, delta, zbase)
            pa = gwp * jf["a"]
            pb = gwp * jf["bp"]
            out = dict(acc)
            for ax, dd in zip("xyz", d3):
                out["pa" + ax] = acc["pa" + ax] + jnp.where(g, jnp.sum(pa * dd, 1), 0.0)
                out["pb" + ax] = acc["pb" + ax] + jnp.where(g, jnp.sum(pb * dd, 1), 0.0)
                out["vb" + ax] = (acc["vb" + ax] + jnp.where(
                    g, jnp.sum(gwv * jf["cv" + ax], 1), 0.0))
            out["vc"] = acc["vc"] + jnp.where(g, jnp.sum(gwv * jf["dv"], 1), 0.0)
            if use_a:
                # Monaghan Π for approaching pairs (extensions.py); sites
                # carry a per-site velocity (key includes vel when avisc on)
                vr = ((ivel[0] - jf["vx"]) * dx + (ivel[1] - jf["vy"]) * dy
                      + (ivel[2] - jf["vz"]) * dz)
                rho_bar = 0.5 * (irho + jf["rho"])
                mu = p.h * vr / (r2 + 0.01 * h2)
                pi_av = jnp.where((vr < 0) & (rho_bar > EPSILON),
                                  -jnp.float32(alpha_visc) * cs * mu
                                  / jnp.maximum(rho_bar, EPSILON), 0.0)
                avw = pi_av * gwp * jf["mult"]
                for ax, dd in zip("xyz", d3):
                    out["av" + ax] = (acc["av" + ax] + jnp.where(
                        g, jnp.sum(avw * dd, 1), 0.0))
            if use_x:
                diff2 = h2 - r2
                wk = jnp.where(diff2 > 0, diff2 * diff2 * diff2, 0.0)
                den = irho + jf["rho"]
                xc = jnp.where(den > EPSILON,
                               2.0 * p.mass / jnp.maximum(den, EPSILON),
                               0.0) * wk
                for ax in "xyz":
                    out["xv" + ax] = (acc["xv" + ax] + jnp.where(
                        g, jnp.sum(xc * jf["vs" + ax], 1), 0.0))
                out["xm"] = acc["xm"] + jnp.where(g, jnp.sum(xc * jf["xmult"], 1), 0.0)
            return out

        return _window_scan(jarrs, r, s, w, body, acc0)

    return run


def combine_forces(sums: dict, i: ISites, p: PhysParams, *,
                   xsph: float = 0.0, alpha_visc: float = 0.0):
    """Site-level force assembly (VelPos.compute:101-105 scaling).

    Returns per-site (fstat f32[3,Ki,S], vcoef f32[Ki,S], xstat, xcoef):
    the per-particle force is fstat − v_i·vcoef (viscosity's −v_i term) and
    the XSPH velocity correction is xstat − v_i·xcoef.
    """
    h6, h9 = p.h ** 6, p.h ** 9
    cp = (45.0 / _PI) / h6
    c6 = (315.0 / (64.0 * _PI)) / h9
    rho = i.rho
    press = p.gas_constant * (rho - p.rest_density)
    i_ok = rho > EPSILON
    safe = jnp.where(i_ok, rho, 1.0)
    sp = jnp.where(i_ok, p.mass * p.mass / safe, 1.0)       # VelPos:101-103
    sv = jnp.where(i_ok, p.viscosity * p.mass * p.mass / safe, 1.0)
    fstat = []
    for ax in "xyz":
        f_press = cp * (press * sums["pa" + ax] + sums["pb" + ax]) * sp
        f_vis_b = cp * sums["vb" + ax] * sv   # cv/dv already carry 1/ρ_j
        f = f_press + f_vis_b
        if alpha_visc != 0.0:
            f = f + cp * p.mass * p.mass * sums["av" + ax]  # no ρ_i scale
        fstat.append(f)
    vcoef = cp * sums["vc"] * sv
    xstat = xcoef = None
    if xsph != 0.0:
        xstat = jnp.stack([jnp.float32(xsph) * c6 * sums["xv" + ax]
                           for ax in "xyz"])
        xcoef = jnp.float32(xsph) * c6 * sums["xm"]
    return jnp.stack(fstat), vcoef, xstat, xcoef


# ---------------------------------------------------------------------------
# per-particle entry points
# ---------------------------------------------------------------------------


def _gather_site(i: ISites, arr: jax.Array, fill=0.0) -> jax.Array:
    """Per-site scalar [Ki,S] → per-particle [N]; dropped particles (no
    evaluation site — certified) read ``fill``."""
    ki, s = i.occ.shape
    idx = jnp.clip(i.slot_of, 0, ki * s - 1)
    return jnp.where(i.slot_of < ki * s, arr.reshape(-1)[idx], fill)


def _escalated(i: ISites, j: JSites, p: PhysParams, runs):
    """Radius-1 window normally; radius 2-3 while spawn δ ≠ 0 (presets can
    lattice past the unit cube before the first clamp; δ up to 2 cells
    observed — beyond that the i-build certificate fires)."""
    branches = [(lambda op, f=f: f(*op)) for f in runs]
    return lax.switch(jnp.clip(i.dmax, 0, len(runs) - 1), branches,
                      (i, j, p))


def density_sites(pos: jax.Array, stale_cid: jax.Array, in_cap: jax.Array,
                  p: PhysParams, r: int, ki: int, kj: int,
                  z_bands: int = 1):
    """Frame-start density per particle (Density.compute:32-60).

    Returns (rho f32[N], cert i32[]). Evaluation uses the same positions the
    bucket was built from (SphFluidSimulation.cs:98-100), so the i-grid is
    both fresh- and stale-centered at once — drift-free by construction.

    ``z_bands > 1`` runs the same pass over sequential z-band-local grids
    (see :func:`auto_bands`) — bit-identical results, O(grid_s) peak grid
    memory instead of O(R³).
    """
    if z_bands > 1:
        return _banded_pass(pos, None, None, stale_cid, in_cap, p, r, ki,
                            kj, z_bands, density=True)
    s = r * r * r
    j = build_j_sites(stale_cid, in_cap, pos, None, None, r, kj, p)
    i = build_i_sites(pos, None, None, r, ki)
    rho_site = _escalated(i, j, p, [make_density_pass(r, s, w)
                                    for w in (1, 2, 3)])
    rho = _gather_site(i, rho_site, 0.0)
    return rho, i.cert + j.cert


def fluid_forces_sites(pos: jax.Array, vel: jax.Array, rho: jax.Array,
                       stale_cid: jax.Array, in_cap: jax.Array,
                       p: PhysParams, r: int, ki: int, kj: int, *,
                       xsph: float = 0.0, alpha_visc: float = 0.0,
                       z_bands: int = 1):
    """Pressure + viscosity (+ extensions) per particle for one substep.

    ``pos``/``vel`` are fresh, ``rho``/``stale_cid``/``in_cap`` frame-stale —
    the reference's candidate semantics (VelPos.compute:57-58, 77-94).
    Returns (f_fluid f32[N,3], xsph_dv f32[N,3] | None, cert i32[]).

    ``z_bands > 1`` runs z-band-local grids (see :func:`auto_bands`).
    """
    if z_bands > 1:
        return _banded_pass(pos, vel, rho, stale_cid, in_cap, p, r, ki,
                            kj, z_bands, density=False, xsph=xsph,
                            alpha_visc=alpha_visc)
    s = r * r * r
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0
    j = build_j_sites(stale_cid, in_cap, pos, vel, rho, r, kj, p,
                      xsph=use_x, avisc=use_a)
    i = build_i_sites(pos, vel if use_a else None, rho, r, ki, avisc=use_a)
    sums = _escalated(
        i, j, p,
        [make_force_pass(r, s, w, xsph=xsph, alpha_visc=alpha_visc)
         for w in (1, 2, 3)])
    fstat, vcoef, xstat, xcoef = combine_forces(sums, i, p, xsph=xsph,
                                                alpha_visc=alpha_visc)
    f = (jnp.stack([_gather_site(i, fstat[a]) for a in range(3)], -1)
         - vel * _gather_site(i, vcoef)[:, None])
    dv = None
    if use_x:
        dv = (jnp.stack([_gather_site(i, xstat[a]) for a in range(3)], -1)
              - vel * _gather_site(i, xcoef)[:, None])
    return f, dv, i.cert + j.cert


# ---------------------------------------------------------------------------
# z-banded grids (flagship-scale variant)
# ---------------------------------------------------------------------------

# Largest grid (cells) the auto rule runs as one piece. Measured on an
# H100 80GB (PERF.md): one band at R=75 (1,048,576 particles) ran 1.33x
# faster than five bands, and one band at R=118 (4,194,304, the reference's
# cap) peaked at 25.0 GB. Peak memory grows with R³, so 2^21 cells (R ≤ 128,
# ~32 GB) keeps every scaled scene up to the cap in one band inside the 60 GB
# a process reserves; only larger grids are banded.
SITE_BAND_AUTO_CELLS = 1 << 21
_BAND_HALO = 3  # planes; covers the widest spawn-escalation window (w=3)


def auto_bands(r: int) -> int:
    """Smallest band count whose band-local grid fits the auto budget
    (1 == use the plain full-grid pass)."""
    if r * r * r <= SITE_BAND_AUTO_CELLS:
        return 1
    for nb in range(2, r + 1):
        zspan = -(-r // nb)
        if (zspan + 2 * _BAND_HALO) * r * r <= SITE_BAND_AUTO_CELLS:
            return nb
    return r


def _banded_pass(pos, vel, rho, stale_cid, in_cap, p: PhysParams, r: int,
                 ki: int, kj: int, nb: int, *, density: bool,
                 xsph: float = 0.0, alpha_visc: float = 0.0):
    """One density or force pass as ``nb`` sequential z-band-local grids.

    Band b owns fresh planes [b·zspan, (b+1)·zspan); its grid spans those
    plus ``_BAND_HALO`` halo planes each side, so every window offset the
    escalated pass can take (|oz| ≤ 3) reads real candidates. Site ranks
    within a voxel depend only on that voxel's rows (a voxel lies wholly
    in one plane), so each band's grid holds exactly the full grid's
    sites for its planes and each i-site accumulates the identical
    candidate set in the identical order: density is bit-identical to the
    one-piece pass, and the force pass differs only where XLA fuses and
    FMA-contracts differently per grid extent (ULP level, pinned in
    tests/test_sites.py).
    Certificates count each voxel's drops in its interior owner band only.
    """
    n = pos.shape[0]
    zspan = -(-r // nb)
    s_loc = (zspan + 2 * _BAND_HALO) * r * r
    s_glob = r * r * r
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0

    fz = jnp.clip((pos[:, 2] * (r - 1)).astype(jnp.int32), 0, r - 1)
    in_rng = (stale_cid >= 0) & (stale_cid < s_glob)
    sz = jnp.where(in_rng, stale_cid // (r * r), -_BAND_HALO - 1)

    def band(carry, zb0):
        lo = zb0 - _BAND_HALO
        j_mem = in_cap & in_rng & (sz >= lo) & (sz < zb0 + zspan
                                                + _BAND_HALO)
        j_int = (sz >= zb0) & (sz < zb0 + zspan)
        i_mem = (fz >= zb0) & (fz < zb0 + zspan)
        cid_loc = stale_cid - lo * (r * r)
        if density:
            j = build_j_sites(cid_loc, in_cap, pos, None, None, r, kj, p,
                              grid_s=s_loc, member=j_mem,
                              cert_member=j_int)
            i = build_i_sites(pos, None, None, r, ki, grid_s=s_loc,
                              zbase=lo, member=i_mem)
            rho_site = _escalated(
                i, j, p, [make_density_pass(r, s_loc, w, zbase=lo)
                          for w in (1, 2, 3)])
            rho_acc, cert = carry
            rho_b = _gather_site(i, rho_site, 0.0)
            return (jnp.where(i_mem, rho_b, rho_acc),
                    cert + i.cert + j.cert), None

        j = build_j_sites(cid_loc, in_cap, pos, vel, rho, r, kj, p,
                          xsph=use_x, avisc=use_a, grid_s=s_loc,
                          member=j_mem, cert_member=j_int)
        i = build_i_sites(pos, vel if use_a else None, rho, r, ki,
                          avisc=use_a, grid_s=s_loc, zbase=lo,
                          member=i_mem)
        sums = _escalated(
            i, j, p,
            [make_force_pass(r, s_loc, w, xsph=xsph,
                             alpha_visc=alpha_visc, zbase=lo)
             for w in (1, 2, 3)])
        fstat, vcoef, xstat, xcoef = combine_forces(
            sums, i, p, xsph=xsph, alpha_visc=alpha_visc)
        fs, vc, xs, xc, cert = carry

        def upd(acc, site_arr):
            return jnp.where(i_mem, _gather_site(i, site_arr, 0.0), acc)

        fs = [upd(fs[a], fstat[a]) for a in range(3)]
        vc = upd(vc, vcoef)
        if use_x:
            xs = [upd(xs[a], xstat[a]) for a in range(3)]
            xc = upd(xc, xcoef)
        return (fs, vc, xs, xc, cert + i.cert + j.cert), None

    zb0s = jnp.arange(nb, dtype=jnp.int32) * zspan
    zero = jnp.zeros(n, jnp.float32)
    if density:
        (rho_out, cert), _ = lax.scan(band, (zero, jnp.int32(0)), zb0s)
        return rho_out, cert
    carry0 = ([zero] * 3, zero, [zero] * 3 if use_x else None,
              zero if use_x else None, jnp.int32(0))
    (fs, vc, xs, xc, cert), _ = lax.scan(band, carry0, zb0s)
    f = jnp.stack(fs, -1) - vel * vc[:, None]
    dv = (jnp.stack(xs, -1) - vel * xc[:, None]) if use_x else None
    return f, dv, cert
