"""The clump-medium flights: the dense flight (kernel K9) and the CSR clump
walker (kernel K10).

Counterparts of make_fly_clump_dense (lart_tpu/transport/engine.py:
3076-3339) and make_fly_clump (:3342-3723) without atmospheres.  Photons
carry global frequencies in reference Doppler units; each clump's opacity
is its rhokap times the line's profile at its
local frequency (x - u) r_loc, at the clumps' damping a_cl and Doppler width
D_cl, plus its rhokapD with dust (transport/flight.py ClumpGrid).  An escape
is binned at the lane's frequency, a completed forced first scattering at its
birth frequency along its birth direction (no velocity shift: the clumps
move, the vacuum does not).  No random numbers are drawn.  With
save_all_photons (tallies.allph) a lane that dies writes its death row
(engine.py:3302-3327, :3684-3711): an escape at its frequency, a forced
first scattering born in vacuum at its birth frequency.

K9 (populations of at most clump_dense_max clumps) resolves a whole flight
in one step: the optical depth from the lane to distance t along its ray is
F(t) = sum_n k_n |chord_n ^ [0, t]| over all N clumps, summed in index order;
the lane escapes where F at the bounding cube's exit t_box falls short of
its target, else the scatter point comes from 12 bisection rounds of F and
one interpolation inside the last bracket.  A forced first scattering (FFS)
completes in one step: F(t_box) is the exact optical depth to the edge.  In
non-overlap mode the clump whose chord holds the scatter point (within the
nudge) becomes the lane's cell; in overlap mode the cell stays -1 and the
scatter draws the owner (K4).

K10 walks the CSR grid one segment a step, at most max_steps a call.  In
non-overlap mode a lane inside clump ic runs to its far intersection, one in
the vacuum to the nearest entry among its CSR cell's K candidates or, if
none, across the cell's exit face plus the nudge.  In overlap mode each step
crosses one CSR cell: its optical depth is the sum of the candidates' chord
overlaps clipped to the cell segment, and a scatter point inside it inverts
that piecewise-linear sum at its 2K sorted breakpoints; ic stays -1.

The plain versions below sum over clumps or candidates in index order, in
explicit loops, as the kernels do, and sort with torch.sort.  The sums of
lart_tpu's dense forms (jnp.sum over (B, N)) take another order, so a
last-ulp difference there can flip one bisection round: the tests compare
the plain versions with lart_tpu at a stated tolerance and share of lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from .allph import record_deaths
from .flight import (BIG, FFS_TAU_CAP, TINY, ClumpGrid, FlightConsts,
                     chord_det, f32, fma, tally_plain)
from .state import (AT_SCATTER, DEAD, FFS, FLYING, LANE_FIELDS, BatchState,
                    Tallies)

N_BISECT = 12
# the CSR walker's candidates a row that a kernel thread sorts in registers
K_MAX = 16
# the crossed chords a K9 thread keeps in its list (CLUMP_CHORDS in
# csrc/fly_clump.cu); a ray that crosses more recomputes F from every clump
CHORDS = 24


@dataclasses.dataclass(frozen=True, eq=False)
class ClumpFlight(FlightConsts):
    """The walk's constants and the clumps (FlightConsts.clump); calling it
    flies a batch through K9 or K10.  rhokap, rhokapD and the velocities
    are per clump; the escape tally bins kz over [-1, 1] whatever
    xyz_symmetry says, as lart_tpu's clump flights do."""

    @classmethod
    def from_clumps(cls, cfg, meta, cmeta, dev) -> 'ClumpFlight':
        """Constants of a clump config that engine.check_supported
        accepted; dev is the population's ClumpDevice."""
        par = cfg.par
        R = meta.xmax
        cl = ClumpGrid.from_meta(cfg, meta, cmeta, dev)
        if not cl.dense and cl.overlap and cl.K > K_MAX:
            raise ValueError(
                f'clump population has K = {cl.K} candidates a CSR cell; the '
                f'overlap walker sorts at most {K_MAX} (raise K_MAX in '
                f'transport/fly_clump.py and csrc/fly_clump.cu)')
        return cls(
            n=(1, 1, 1), bc=('escape',) * 3, cell0=(0, 0, 0),
            walk=(True, True, True), amin=(-R,) * 3, amax=(R,) * 3,
            d=(2 * R,) * 3, a_ref=meta.voigt_a_ref, Dfreq=meta.Dfreq_ref,
            xfreq_min=meta.xfreq_min, dxfreq=meta.dxfreq,
            nxfreq=meta.nxfreq, save_Jmu=bool(par.save_Jmu), nmu=par.nmu,
            mu_min=-1.0, dmu=2.0 / par.nmu, mu_abs=False, sphere_R2=1.0,
            sphere_rho=-1.0, sphere_rhoD=0.0, rhokap=dev.rhokap,
            vel=(dev.vx, dev.vy, dev.vz) if cl.moving else None,
            rhokapD=dev.rhokapD, line=pline.LineConsts.from_config(cfg),
            clump=cl)

    def __call__(self, state: BatchState, tallies: Tallies,
                 max_steps: int) -> None:
        fly(state, tallies, self, max_steps)

    def flat(self, i, j=None, k=None) -> torch.Tensor:
        """The lanes' clumps (-1 in the vacuum): the index of the per-clump
        arrays, as FlightConsts.flat is of a Cartesian grid's."""
        return i.long()

    def vel_dot(self, cell, kx, ky, kz) -> torch.Tensor:
        """u . k of the clumps cell[0] in reference units
        (engine.cell_velocity_dot)."""
        return self.clump.vel_dot(cell[0], kx, ky, kz, 'scale')


def _seqsum(terms: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of `terms` in index order, one f32 add at
    a time, as a kernel thread sums."""
    cols = terms.movedim(-1, 0).contiguous()
    acc = torch.zeros_like(cols[0])
    for c in cols:
        acc = acc + c
    return acc


def _box_exit(R: float, pos, k) -> torch.Tensor:
    """Distance along k to the bounding cube's face (engine.py:3124-3131)."""
    t = []
    for a in range(3):
        flat = torch.abs(k[a]) < 1e-12
        face = torch.where(k[a] > 0.0, R, -R)
        ta = (face - pos[a]) / torch.where(flat, torch.ones_like(k[a]), k[a])
        t.append(torch.where(flat, torch.full_like(ta, BIG),
                             torch.clamp_min(ta, 0.0)))
    return torch.minimum(torch.minimum(t[0], t[1]), t[2])


def dense_chords(p: ClumpFlight, s: BatchState):
    """(t_box, t0, t1, kq) of engine.py:3120-3157: the cube's exit distance
    and the (B, N) chord knots of every clump clipped to [0, t_box], with
    each clump's opacity at the lane's frequency (0 where the ray misses)."""
    cl, d = p.clump, p.clump.dev
    pos, k = (s.x, s.y, s.z), (s.kx, s.ky, s.kz)
    t_box = _box_exit(cl.R, pos, k)
    px, py, pz = (v[:, None] - c[None, :] for v, c in zip(pos, (d.x, d.y,
                                                               d.z)))
    kk = [v[:, None] for v in k]
    b, det = chord_det(px, py, pz, *kk, d.r2[None, :])
    sq = torch.sqrt(torch.clamp_min(det, 0.0))
    tb = t_box[:, None]
    t0 = torch.minimum(torch.clamp_min(-b - sq, 0.0), tb)
    t1 = torch.minimum(torch.clamp_min(-b + sq, 0.0), tb)
    if cl.moving:
        ic = torch.arange(cl.n, device=s.device)[None, :].expand_as(px)
        u = cl.vel_dot(ic, *kk, form='vr')
        x_loc = cl.local_x(s.xfreq[:, None], u)
    else:
        x_loc = cl.local_x(s.xfreq)[:, None]
    prof = pline.line_profile_plain(p.line, x_loc, f32(cl.a_cl),
                                    f32(cl.D_cl))
    kq = d.rhokap[None, :] * prof
    if cl.has_dust:
        kq = kq + d.rhokapD[None, :]
    return t_box, t0, t1, torch.where(det > 0.0, kq, torch.zeros_like(kq))


def crossed_chords(p: 'ClumpFlight', s: BatchState) -> torch.Tensor:
    """(B,) the chords with gas each lane's ray crosses in the bounding cube
    (those K9 lists; a lane with more than CHORDS takes its second path)."""
    _, t0, t1, kq = dense_chords(p, s)
    return ((t1 > t0) & (kq > 0.0)).sum(dim=1)


def _depth_to(t, t0, t1, kq) -> torch.Tensor:
    """F(t) = sum_n kq_n max(min(t, t1_n) - t0_n, 0), in index order."""
    return _seqsum(kq * torch.clamp_min(torch.minimum(t[:, None], t1) - t0,
                                        0.0))


def dense_scatter_dist(tau_need, tau_tot, t_box, t0, t1, kq):
    """engine.py:3159-3179: N_BISECT rounds of bisection of the monotone
    F(t) = tau_need, then the interpolation inside the last bracket."""
    lo, hi = torch.zeros_like(t_box), t_box
    Flo, Fhi = torch.zeros_like(t_box), tau_tot
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        Fm = _depth_to(mid, t0, t1, kq)
        less = Fm < tau_need
        lo, hi = torch.where(less, mid, lo), torch.where(less, hi, mid)
        Flo, Fhi = torch.where(less, Fm, Flo), torch.where(less, Fhi, Fm)
    frac = torch.clamp((tau_need - Flo) / torch.clamp_min(Fhi - Flo, TINY),
                       0.0, 1.0)
    return fma(frac, hi - lo, lo)


def dense_owner_at(eps: float, d_hit, t0, t1, kq) -> torch.Tensor:
    """owner_at (engine.py:3181-3189): the first clump whose chord holds
    d_hit within eps (with gas), -1 for none."""
    dd = d_hit[:, None]
    inside = (t0 - eps <= dd) & (dd <= t1 + eps) & (kq > 0.0)
    first = torch.argmax(inside.to(torch.int8), dim=1)
    return torch.where(inside.any(dim=1), first, torch.full_like(first, -1))


def _ffs_and_commit(s: BatchState, tallies: Tallies, p: ClumpFlight,
                    moving, is_ffs, hit, esc_fly, ffs_done, tau0, tau_n,
                    pos_n, ic_n):
    """The escape and FFS tallies and the lane update shared by both
    flights (engine.py:3227-3306, :3591-3680): returns this step's
    out-of-grid weight, summed."""
    oor = tally_plain(tallies, p, esc_fly, s.xfreq, s.wgt, s.kz)
    if tallies.allph is not None:
        # the death rows' frequencies (engine.py:3302-3318)
        xf2 = torch.where(ffs_done, s.bxfreq, s.xfreq)
    wgt_esc = s.wgt * torch.exp(-tau0)
    oor = oor + tally_plain(tallies, p, ffs_done, s.bxfreq, wgt_esc, s.bkz)
    wgt1 = -torch.expm1(-tau0)
    ffs_vacuum = ffs_done & (tau0 <= 0.0)
    phase_new = torch.where(
        esc_fly | ffs_vacuum, DEAD,
        torch.where(ffs_done, FLYING,
                    torch.where(hit & ~is_ffs, AT_SCATTER, s.phase))
    ).to(torch.int32)
    new_target = torch.where(
        ffs_done, -torch.log1p(-torch.clamp_max(s.tau_target, 0.99999)
                               * wgt1), s.tau_target)
    s.phase.copy_(torch.where(moving, phase_new, s.phase))
    for name, new in zip(('x', 'y', 'z', 'ic'), (*pos_n, ic_n)):
        cur = getattr(s, name)
        cur.copy_(torch.where(ffs_done, getattr(s, 'b' + name),
                              torch.where(moving, new.to(cur.dtype), cur)))
    for name in ('kx', 'ky', 'kz'):
        cur = getattr(s, name)
        cur.copy_(torch.where(ffs_done, getattr(s, 'b' + name), cur))
    s.wgt.copy_(torch.where(ffs_done, s.wgt * wgt1, s.wgt))
    s.tau_run.copy_(torch.where(ffs_done, torch.zeros_like(tau_n),
                                torch.where(moving, tau_n, s.tau_run)))
    s.tau_target.copy_(new_target)
    if tallies.allph is not None:
        record_deaths(tallies.allph, s, moving & (esc_fly | ffs_vacuum), xf2)
    return oor.sum()


def _moving_lanes(state: BatchState, step) -> bool:
    """Run step(sub) on the FLYING/FFS lanes of state only (each lane's
    arithmetic depends on no other), writing them back; False when none
    moves."""
    idx = ((state.phase == FLYING) | (state.phase == FFS)).nonzero()
    if idx.numel() == 0:
        return False
    idx = idx.squeeze(1)
    sub = state.select(idx)
    step(sub)
    for f in LANE_FIELDS:
        getattr(state, f)[idx] = getattr(sub, f)
    return True


def fly_dense_plain(state: BatchState, tallies: Tallies, p: ClumpFlight,
                    max_steps: int, stats=None) -> None:
    """Plain PyTorch dense flight (K9) of every FLYING/FFS lane, in place;
    stats, a dict, gains the lane-steps taken ('steps') and the chords
    they crossed ('chords')."""
    cl = p.clump
    oor = [torch.zeros((), device=state.device)]

    def step(s):
        is_ffs = s.phase == FFS
        moving = torch.ones_like(is_ffs)
        t_box, t0, t1, kq = dense_chords(p, s)
        if stats is not None:
            stats['steps'] = stats.get('steps', 0) + s.batch
            stats['chords'] = stats.get('chords', 0) + int(
                ((t1 > t0) & (kq > 0.0)).sum())
        tau_tot = _seqsum(kq * (t1 - t0))
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        tau_need = tgt - s.tau_run
        hit = tau_tot >= tau_need
        d_hit = dense_scatter_dist(tau_need, tau_tot, t_box, t0, t1, kq)
        d_adv = torch.where(hit, d_hit, t_box + cl.eps_dense)
        pos_n = [fma(d_adv, k, x) for x, k in ((s.x, s.kx), (s.y, s.ky),
                                                (s.z, s.kz))]
        if cl.overlap:
            ic_sc = torch.full_like(s.ic, -1)
        else:
            ic_sc = dense_owner_at(cl.eps_dense, d_hit, t0, t1, kq)
        ic_n = torch.where(hit, ic_sc.to(s.ic.dtype), s.ic)
        esc_fly = ~is_ffs & ~hit
        tau0 = torch.clamp_max(s.tau_run + tau_tot, FFS_TAU_CAP)
        oor[0] = oor[0] + _ffs_and_commit(
            s, tallies, p, moving, is_ffs, hit, esc_fly, is_ffs, tau0, tgt,
            pos_n, ic_n)
    for _ in range(max_steps):
        if not _moving_lanes(state, step):
            break       # the remaining iterations would change nothing
    tallies.W_oor += oor[0]


def seg_and_next(p: ClumpFlight, s: BatchState):
    """engine.py:3380-3439: (segment length to the next change of medium,
    the clump after it) of every lane: inside clump ic its far
    intersection (-1 after); in the vacuum the nearest entry among the CSR
    cell's candidates, or the cell's exit face plus the nudge (-1 after)."""
    cl = p.clump
    eps = cl.eps_csr
    pos, k = (s.x, s.y, s.z), (s.kx, s.ky, s.kz)
    inside = s.ic >= 0
    ic = s.ic.long()
    cx, cy, cz, _ = cl.centre(ic)
    cr2 = cl.gather(cl.dev.r2, ic, 1.0)
    b, det = chord_det(s.x - cx, s.y - cy, s.z - cz, *k, cr2)
    t_exit_cl = -b + torch.sqrt(torch.clamp_min(det, 0.0))
    cell, t_cell = cl.cell_exit(pos, k)
    t_entry = torch.full_like(s.x, BIG)
    next_ic = torch.full_like(ic, -1)
    for q in range(cl.K):
        cand = cl.candidate(cell, q)
        qx, qy, qz, qr2 = cl.centre(cand)
        eb, edet = chord_det(s.x - qx, s.y - qy, s.z - qz, *k, qr2)
        tin = -eb - torch.sqrt(torch.clamp_min(edet, 0.0))
        better = ((cand >= 0) & (edet > 0.0) & (tin > eps)
                  & (tin <= t_cell + eps) & (tin < t_entry))
        t_entry = torch.where(better, tin, t_entry)
        next_ic = torch.where(better, cand, next_ic)
    entering = t_entry < BIG
    t_vac = torch.where(entering, t_entry, t_cell + eps)
    t_seg = torch.where(inside, t_exit_cl, t_vac)
    ic_after = torch.where(inside | ~entering, torch.full_like(next_ic, -1),
                           next_ic)
    return t_seg, ic_after


def overlap_segment(p: ClumpFlight, s: BatchState):
    """engine.py:3441-3508: (t_end, dtau, tq0, tq1, kq) of the lanes' CSR
    cells: the cell segment's end (its exit face plus the nudge), its
    optical depth summed over the candidates in table order, and the (K, B)
    candidates' chord knots clipped to [0, t_end] with their opacities."""
    cl = p.clump
    pos, k = (s.x, s.y, s.z), (s.kx, s.ky, s.kz)
    cell, t_cell = cl.cell_exit(pos, k)
    t_end = t_cell + cl.eps_csr
    dtau = torch.zeros_like(s.x)
    tq0, tq1, kqs = [], [], []
    for q in range(cl.K):
        cand = cl.candidate(cell, q)
        qx, qy, qz, qr2 = cl.centre(cand)
        eb, edet = chord_det(s.x - qx, s.y - qy, s.z - qz, *k, qr2)
        sq = torch.sqrt(torch.clamp_min(edet, 0.0))
        t0 = torch.minimum(torch.clamp_min(-eb - sq, 0.0), t_end)
        t1 = torch.minimum(torch.clamp_min(-eb + sq, 0.0), t_end)
        u = cl.vel_dot(cand, *k, form='vr') if cl.moving else None
        kq = cl.kappa(p.line, cand, cl.local_x(s.xfreq, u))
        kq = torch.where((cand >= 0) & (edet > 0.0), kq,
                         torch.zeros_like(kq))
        dtau = fma(kq, t1 - t0, dtau)
        tq0.append(t0)
        tq1.append(t1)
        kqs.append(kq)
    return t_end, dtau, torch.stack(tq0), torch.stack(tq1), torch.stack(kqs)


def overlap_scatter_dist(tau_need, t_end, tq0, tq1, kq) -> torch.Tensor:
    """engine.py:3510-3531: F(t) = sum_q kq max(min(t, tq1) - tq0, 0) at
    the 2K sorted breakpoints, the first reaching tau_need, and the
    interpolation below it (from 0 before the first breakpoint)."""
    tb = torch.sort(torch.cat([tq0, tq1], dim=0), dim=0).values   # (2K, B)
    F = torch.stack([_seqsum((kq * torch.clamp_min(
        torch.minimum(t[None, :], tq1) - tq0, 0.0)).t()) for t in tb])
    ge = F >= tau_need[None, :]
    j = torch.argmax(ge.to(torch.int8), dim=0)
    jm = torch.clamp_min(j - 1, 0)

    def at(a, i):
        return torch.gather(a, 0, i[None, :])[0]
    t_lo, t_hi, F_lo, F_hi = at(tb, jm), at(tb, j), at(F, jm), at(F, j)
    frac = torch.clamp((tau_need - F_lo) / torch.clamp_min(F_hi - F_lo, TINY),
                       0.0, 1.0)
    d = fma(frac, torch.clamp_min(t_hi - t_lo, 0.0), t_lo)
    d0 = tb[0] * torch.clamp(tau_need / torch.clamp_min(F[0], TINY), 0.0,
                             1.0)
    return torch.minimum(torch.clamp_min(torch.where(j == 0, d0, d), 0.0),
                         t_end)


def fly_csr_plain(state: BatchState, tallies: Tallies, p: ClumpFlight,
                  max_steps: int, stats=None) -> None:
    """Plain PyTorch CSR walk (K10) of every FLYING/FFS lane, in place;
    stats, a dict, gains the lane-steps taken ('steps') and marks the CSR
    cells they stood in ('cells')."""
    cl = p.clump
    R = cl.R
    oor = [torch.zeros((), device=state.device)]

    def step(s):
        is_ffs = s.phase == FFS
        moving = torch.ones_like(is_ffs)
        if stats is not None:
            _csr_stats(stats, cl, s)
        tgt = torch.where(is_ffs, torch.full_like(s.tau_target, FFS_TAU_CAP),
                          s.tau_target)
        k = (s.kx, s.ky, s.kz)
        if cl.overlap:
            t_end, dtau, tq0, tq1, kq = overlap_segment(p, s)
            hit = s.tau_run + dtau >= tgt
            d_hit = overlap_scatter_dist(tgt - s.tau_run, t_end, tq0, tq1, kq)
            d_adv = torch.where(hit, d_hit, t_end)
            ic_after = torch.full_like(s.ic, -1)
        else:
            inside = s.ic >= 0
            ic = s.ic.long()
            u = cl.vel_dot(ic, *k, form='scale')
            kap = torch.where(inside, cl.kappa(p.line, ic,
                                               cl.local_x(s.xfreq, u)),
                              torch.zeros_like(s.x))
            t_seg, ic_after = seg_and_next(p, s)
            dtau = t_seg * kap
            hit = s.tau_run + dtau >= tgt
            d_hit = (tgt - s.tau_run) / torch.clamp_min(kap, TINY)
            d_adv = torch.where(hit, d_hit, t_seg + cl.eps_csr)
        pos_n = [fma(d_adv, kk, x) for x, kk in zip((s.x, s.y, s.z), k)]
        tau_n = torch.where(hit, tgt, s.tau_run + dtau)
        crossed = ~hit
        ic_n = torch.where(crossed, ic_after.to(s.ic.dtype), s.ic)
        escaped = crossed & ((torch.abs(pos_n[0]) >= R)
                             | (torch.abs(pos_n[1]) >= R)
                             | (torch.abs(pos_n[2]) >= R))
        esc_fly = escaped & (s.phase == FLYING)
        ffs_done = (escaped & is_ffs) | (hit & is_ffs)
        oor[0] = oor[0] + _ffs_and_commit(
            s, tallies, p, moving, is_ffs, hit, esc_fly, ffs_done, tau_n,
            tau_n, pos_n, ic_n)
    for _ in range(max_steps):
        if not _moving_lanes(state, step):
            break       # the remaining iterations would change nothing
    tallies.W_oor += oor[0]


def _csr_stats(stats, cl: ClumpGrid, s: BatchState) -> None:
    """The lane-steps of the lanes s, and the CSR cells they read."""
    stats['steps'] = stats.get('steps', 0) + s.batch
    if 'cells' not in stats:
        stats['cells'] = torch.zeros(cl.cg_n ** 3, dtype=torch.bool,
                                     device=s.device)
    _, cell = cl.csr_cell(s.x, s.y, s.z)
    stats['cells'][cell] = True


def csr_work(stats, cl: ClumpGrid) -> dict:
    """(distinct CSR cells, distinct candidate clumps of them) of a plain
    walk's stats."""
    cells = stats['cells'].nonzero().squeeze(1)
    rows = cl.dev.table[cells].reshape(-1)
    return {'cells': int(cells.numel()),
            'clumps': int(torch.unique(rows[rows >= 0]).numel())}


def fly_plain(state: BatchState, tallies: Tallies, p: ClumpFlight,
              max_steps: int, stats=None) -> None:
    """The plain version of the flight lart_tpu takes for the population:
    K9's where it is dense, else K10's."""
    (fly_dense_plain if p.clump.dense else fly_csr_plain)(
        state, tallies, p, max_steps, stats)


def fly(state: BatchState, tallies: Tallies, p: ClumpFlight,
        max_steps: int) -> None:
    """Fly every FLYING/FFS lane, in place: K9 (dense) or K10 (CSR) for a
    CUDA state, the plain version for a CPU state."""
    if state.device.type == 'cpu':
        fly_plain(state, tallies, p, max_steps)
        return
    name = 'fly_clump_dense' if p.clump.dense else 'fly_clump_csr'
    kbuild.require_cuda(name, tallies.Jout, tallies.Jmu, tallies.W_oor,
                        state.x, *p.device_tensors(),
                        *(tallies.allph.tensors()
                          if tallies.allph is not None else ()))
    fn = kbuild.library().lart_fly_clump_dense if p.clump.dense \
        else kbuild.library().lart_fly_clump_csr
    kbuild.check(fn(state.lane_pointers, state.batch, max_steps,
                    ctypes.byref(p.c_params(tallies)),
                    kbuild.stream_of(state.x)), name)
    kbuild.LAUNCHES[name] += 1
