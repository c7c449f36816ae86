"""Resonant scattering and dust events (kernel K4).

Counterpart of make_scatter / scatter (lart_tpu/transport/engine.py:1838,
:2087) for line types 1, 2, 4, 5, 6 and 7 without H2: redistribute
(:1931-2086, physics/line.py), rand_resonance_cost with the event's E1,
phi = 2 pi xi, the perpendicular atom velocity with the core-skip boost
(:2197-2205) scaled by the redistribution's perp_scale, xfreq_new, with
recoil xfreq_new - (g0 / D)(1 - cos theta) (:2224-2229), rotate_direction
(:1854) and the next optical depth.

With use_stokes (:2165-2190, :2231-2265, :2486-2496) the azimuth is drawn
by rejection from 1 + (S12/S11)(Q cos 2phi + U sin 2phi) over
scatter_rounds rounds (a lane that fails them stays AT_SCATTER, as one that
fails the u_par rounds does), and the direction, the reference triad
(m, n) and the Stokes vector turn together; the triad is re-orthonormalized
against f32 drift in lart_tpu's order.

With dust (DGR > 0) an event is a dust event with probability
kap_D / (kap_HI + kap_D), kap_HI = rk H(x, a) and kap_D the cell's rhokapD
(the constants sphere_rho and sphere_rhoD on the uniform-sphere fast path;
:2111-2142).  A dust event absorbs with probability 1 - albedo (the lane
dies and its weight goes to Jabs at the lab frequency of its cell), unless
use_reduced_wgt, where nothing is absorbed: the lane's weight times
1 - albedo goes to Jabs and the scattered lane keeps the weight times the
albedo (:2278-2281, :2341, :2446-2447).  A dust scattering keeps xfreq and
turns the direction by Henyey-Greenstein with the resonance branch's
azimuth (:2330-2333), or, with use_stokes, by the tabulated Mueller matrix:
cos(theta) from physics.mueller.sample_cost, the azimuth by rejection as
above with the table's S12/S11 (a lane that fails stays AT_SCATTER), the
triad turned without re-orthonormalization and the Stokes vector through
S11, S12, S33, S34 (:2282-2328).  nscatt_dust sums the weight of every
dust event, absorptions included (:2373-2377).

With peel-off on, the scatter writes a PeelRecord: the kind of each lane's
event (1 a resonance scattering, 2 a dust scattering, 0 neither), the
pre-scatter direction (with use_stokes also the triad and Stokes vector)
and, at a resonance, this event's xfreq_atom and atom velocity
(:2207-2218) and, for line types 2, 4, 5 and 6, its phase weights E1, E2,
E3, which the peel (kernel K7) reads right after.  A dust peel
reads the lane's weight after the scatter, which under use_reduced_wgt is
already the weight times the albedo that lart_tpu peels with (:2342-2347).

Core-skip (local_xcrit, :1872-1905): a lane with |x| < xcrit draws its
perpendicular speed as sqrt(xcrit^2 - log xi).  core_skip_global takes the
grid's xcrit; the local one is cbrt(a rk dl) / 5 where a rk dl > 1, dl the
distance to the nearest face of the lane's cell and rk the cell's rhokap,
or the constant sphere_rho on the uniform-sphere fast path (the scatter
point may sit in a voxel just outside the voxelized ball).

scatter_rounds rejection rounds of the u_par sampler run per call; a lane
still rejected stays AT_SCATTER and retries next cycle.  Uniforms come
from Philox stream STREAM_SCATTER at counter (lane, counter, block): block
r feeds round r, block `rounds` the angles, block rounds + 1 the next tau,
and with use_stokes block rounds + 2 + r the azimuth round r.  The dust
draws come after every block a lane without dust may draw: block
D = 2 rounds + 2 the event split, the absorption and the HG cos(theta),
block D + 1 the Mueller cos(theta), block D + 2 + r its azimuth round r.  So
a run without dust draws as before; a dust scattering reuses block
`rounds` (HG's azimuth) and rounds + 1 (its next tau).  Core-skip draws
nothing new.  A line of type 2 to 7 draws its upper level and downward
branch from block 3 rounds + 4, after the last Mueller azimuth block, so
a Ly-alpha run draws as before.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..kernels import build as kbuild
from ..physics import line as pline
from ..physics import mueller as pmueller
from ..physics import samplers
from ..physics.rng import STREAM_SCATTER, uniforms
from .flight import div
from .state import AT_SCATTER, DEAD, FLYING, BatchState, Tallies

TINY = 1e-30
CORE_SKIP_OFF, CORE_SKIP_LOCAL, CORE_SKIP_GLOBAL = 0, 1, 2
DUST_OFF, DUST_HG, DUST_MUELLER = 0, 1, 2
# the record's kind of event (PeelRecord.flag)
EVENT_RESONANCE, EVENT_DUST = 1, 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def dust_mode(cfg, meta) -> int:
    """How dust scatters in a config: not at all, by Henyey-Greenstein, or
    with use_stokes by the Mueller table (engine.py:1845-1852)."""
    if not meta.has_dust:
        return DUST_OFF
    return DUST_MUELLER if cfg.par.use_stokes else DUST_HG


class ScatterC(ctypes.Structure):
    """csrc/scatter_lya.cu struct ScatterParams, field for field."""
    _fields_ = [('rhokap', _P), ('rhokapD', _P), ('vfx', _P), ('vfy', _P),
                ('vfz', _P), ('nscatt_gas', _P), ('nscatt_events', _P),
                ('Jabs', _P), ('nscatt_dust', _P),
                ('mueller', pmueller.MuellerC),
                ('rounds', _I), ('stokes', _I), ('core_skip', _I),
                ('dust', _I), ('reduced_wgt', _I), ('nxfreq', _I),
                ('n', _I * 3), ('a', _F), ('xcrit', _F), ('xcrit2', _F),
                ('rk_const', _F), ('rkD_const', _F), ('albedo', _F),
                ('one_m_albedo', _F),
                ('hgg', _F), ('xfreq_min', _F), ('dxfreq', _F),
                ('amin', _F * 3), ('d', _F * 3), ('Dfreq', _F),
                ('recoil', _I), ('line', pline.LineC)]


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterParams:
    a: float          # Voigt damping parameter (uniform temperature)
    rounds: int       # rejection rounds per call
    stokes: bool = False       # use_stokes: azimuth, triad and Stokes
    core_skip: int = CORE_SKIP_OFF
    xcrit: float = 0.0         # core_skip_global's threshold and its square
    xcrit2: float = 0.0
    rk_const: float = -1.0     # > 0: sphere_rho on the sphere fast path
    rkD_const: float = 0.0     #   and sphere_rhoD there
    # the flat grid where the scatter gathers it: local core-skip or dust,
    # off the sphere fast path
    rhokap: Optional[torch.Tensor] = None
    n: tuple = (1, 1, 1)
    amin: tuple = (0.0, 0.0, 0.0)
    d: tuple = (1.0, 1.0, 1.0)
    dust: int = DUST_OFF
    albedo: float = 0.0
    hgg: float = 0.0
    reduced_wgt: bool = False
    rhokapD: Optional[torch.Tensor] = None   # flat, dust off the sphere
    vel: Optional[tuple] = None   # flat velocities for Jabs, moving medium
    mueller: Optional[pmueller.MuellerTable] = None   # DUST_MUELLER
    xfreq_min: float = 0.0     # the Jabs frequency bins
    dxfreq: float = 1.0
    nxfreq: int = 0
    line: Optional[pline.LineConsts] = None   # the line (from_config)
    Dfreq: float = 1.0         # Doppler width of every cell (Hz)
    recoil: bool = False

    @classmethod
    def from_config(cls, cfg, meta, grid=None,
                    uniform_sphere=False) -> 'ScatterParams':
        """Constants of a config that engine.check_supported accepted;
        `uniform_sphere` is engine.uniform_sphere_fastpath(cfg, meta)."""
        par = cfg.par
        mode = CORE_SKIP_OFF
        if par.core_skip:
            mode = CORE_SKIP_GLOBAL if par.core_skip_global \
                else CORE_SKIP_LOCAL
        dust = dust_mode(cfg, meta)
        gather = (mode == CORE_SKIP_LOCAL or dust) and not uniform_sphere

        def flat(t):
            return t.reshape(-1).contiguous()
        return cls(a=float(meta.voigt_a_ref),
                   rounds=int(par.scatter_rounds),
                   stokes=bool(par.use_stokes), core_skip=mode,
                   xcrit=float(meta.xcrit), xcrit2=float(meta.xcrit2),
                   rk_const=float(meta.sphere_rho) if uniform_sphere
                   else -1.0,
                   rkD_const=float(meta.sphere_rhoD) if uniform_sphere
                   else 0.0,
                   rhokap=flat(grid.rhokap) if gather else None,
                   n=(meta.nx, meta.ny, meta.nz),
                   amin=(meta.xmin, meta.ymin, meta.zmin),
                   d=(meta.dx, meta.dy, meta.dz),
                   dust=dust, albedo=float(par.albedo), hgg=float(par.hgg),
                   reduced_wgt=bool(par.use_reduced_wgt),
                   rhokapD=flat(grid.rhokapD) if dust and gather else None,
                   vel=tuple(flat(v) for v in (grid.vfx, grid.vfy, grid.vfz))
                   if dust and not meta.static_medium else None,
                   mueller=pmueller.MuellerTable.for_config(
                       cfg, grid.rhokap.device) if dust else None,
                   xfreq_min=meta.xfreq_min, dxfreq=meta.dxfreq,
                   nxfreq=meta.nxfreq,
                   line=pline.LineConsts.from_config(cfg),
                   Dfreq=float(meta.Dfreq_ref), recoil=bool(par.recoil))

    @property
    def dust_block(self) -> int:
        """The first Philox block of the dust draws."""
        return 2 * self.rounds + 2

    def flat(self, s: BatchState) -> torch.Tensor:
        """The lanes' flat cell index, clamped like jnp.take mode='clip'."""
        nx, ny, nz = self.n
        f = (s.ic.long() * ny + s.jc) * nz + s.kc
        return torch.clamp(f, 0, nx * ny * nz - 1)

    def device_tensors(self):
        out = tuple(t for t in (self.rhokap, self.rhokapD) if t is not None)
        out += self.vel or ()
        return out + (self.mueller.tensors() if self.mueller else ())

    @functools.cached_property
    def _c_params(self) -> ScatterC:
        c = ScatterC()
        for f in ('rhokap', 'rhokapD'):
            t = getattr(self, f)
            setattr(c, f, None if t is None else t.data_ptr())
        if self.vel is not None:
            c.vfx, c.vfy, c.vfz = (v.data_ptr() for v in self.vel)
        if self.mueller is not None:
            c.mueller = self.mueller.c_struct
        c.rounds, c.stokes, c.core_skip = (self.rounds, int(self.stokes),
                                           self.core_skip)
        c.dust, c.reduced_wgt, c.nxfreq = (self.dust, int(self.reduced_wgt),
                                           self.nxfreq)
        c.n[:], c.amin[:], c.d[:] = self.n, self.amin, self.d
        for f in ('a', 'xcrit', 'xcrit2', 'rk_const',
                  'rkD_const', 'albedo', 'hgg', 'xfreq_min', 'dxfreq',
                  'Dfreq'):
            setattr(c, f, getattr(self, f))
        c.recoil = int(self.recoil)
        c.line = self.line.c_struct
        # 1 - albedo in f64, then f32, as lart_tpu's weak-typed constant
        c.one_m_albedo = 1.0 - self.albedo
        return c

    def c_params(self, tallies: Tallies) -> ScatterC:
        """The C struct with this call's tally pointers (the launch copies
        it, so the next call may overwrite them)."""
        c = self._c_params
        for f in ('nscatt_gas', 'nscatt_events', 'Jabs', 'nscatt_dust'):
            setattr(c, f, getattr(tallies, f).data_ptr())
        return c


def local_xcrit(s: BatchState, p: ScatterParams):
    """(xcrit, xcrit^2) of every lane (engine.py:1872-1905)."""
    if p.core_skip == CORE_SKIP_GLOBAL:
        return (torch.full_like(s.x, p.xcrit),
                torch.full_like(s.x, p.xcrit2))
    dl = None
    for pos, c, amin, d in zip((s.x, s.y, s.z), (s.ic, s.jc, s.kc), p.amin,
                               p.d):
        f = amin + c.to(torch.float32) * d
        dla = torch.minimum(pos - f, f + d - pos)
        dl = dla if dl is None else torch.minimum(dl, dla)
    if p.rk_const > 0.0:
        rk = torch.full_like(s.x, p.rk_const)
    else:
        rk = p.rhokap[p.flat(s)]
    atau = p.a * rk * torch.clamp_min(dl, 0.0)
    # torch has no cbrt: the f64 cube root rounded to f32
    cbrt = torch.pow(atau.double(), 1.0 / 3.0).float()
    xc = torch.where(atau > 1.0, div(cbrt, 5.0), torch.zeros_like(atau))
    return xc, xc * xc


def rotate_direction(kx, ky, kz, cost, sint, cosp, sinp):
    """New unit direction from scattering angles about (kx, ky, kz)."""
    near_pole = torch.abs(kz) >= 0.99999999999
    kr = torch.sqrt(torch.clamp_min(kx * kx + ky * ky, TINY))
    nkx = cost * kx + sint * (kz * kx * cosp - ky * sinp) / kr
    nky = cost * ky + sint * (kz * ky * cosp + kx * sinp) / kr
    nkz = cost * kz - sint * cosp * kr
    kx2 = torch.where(near_pole, sint * cosp, nkx)
    ky2 = torch.where(near_pole, sint * sinp, nky)
    kz2 = torch.where(near_pole, torch.where(kz > 0, cost, -cost), nkz)
    norm = torch.rsqrt(kx2 * kx2 + ky2 * ky2 + kz2 * kz2)
    return kx2 * norm, ky2 * norm, kz2 * norm


def azimuth_rounds(s: BatchState, S12o, u_rounds):
    """The azimuth by rejection from 1 + S12o (Q cos 2phi + U sin 2phi),
    one round per block of u_rounds (rounds, 4, B): (accepted, phi)."""
    pmag = torch.sqrt(s.Q * s.Q + s.U * s.U)
    acc = torch.zeros_like(s.x, dtype=torch.bool)
    phi = torch.zeros_like(s.x)
    for v in u_rounds:
        phi_p = samplers.TWOPI * v[0]
        prand = (1.0 + torch.abs(S12o) * pmag) * v[1]
        pcomp = 1.0 + S12o * (s.Q * torch.cos(2.0 * phi_p)
                              + s.U * torch.sin(2.0 * phi_p))
        take = ~acc & (prand <= pcomp)
        phi = torch.where(take, phi_p, phi)
        acc = acc | take
    return acc, phi


def scatter_plain(state: BatchState, tallies: Tallies, p: ScatterParams,
                  seed: int, counter: int, record=None) -> None:
    """Plain PyTorch scatter of every AT_SCATTER lane, in place; fills
    `record` (a PeelRecord) when it is given."""
    s = state
    lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
    at_sc = s.phase == AT_SCATTER
    is_dust = torch.zeros_like(at_sc)
    lc = p.line
    if p.dust:
        ud = uniforms(seed, STREAM_SCATTER, lanes, counter, p.dust_block)
        if p.rk_const > 0.0:
            rk = torch.full_like(s.x, p.rk_const)
            kap_D = torch.full_like(s.x, p.rkD_const)
        else:
            f = p.flat(s)
            rk, kap_D = p.rhokap[f], p.rhokapD[f]
        kap_HI = rk * pline.line_profile_plain(lc, s.xfreq, p.a, p.Dfreq)
        is_dust = at_sc & (ud[0] <= kap_D / torch.clamp_min(kap_HI + kap_D,
                                                            TINY))
    is_res = at_sc & ~is_dust
    u = uniforms(seed, STREAM_SCATTER, lanes, counter, range(p.rounds + 2))
    sel = None if lc.line_type == 1 else uniforms(
        seed, STREAM_SCATTER, lanes, counter, 3 * p.rounds + 4)
    red = pline.redistribute_plain(lc, s.xfreq, p.a, p.Dfreq,
                                   u[:p.rounds], sel, is_res)
    acc, uz, xfreq_atom = red.acc, red.uz, red.xatom
    E1, E2, E3 = red.E1, red.E2, red.E3

    xi = u[p.rounds]
    cost = samplers.rand_resonance_cost(xi[0], E1)
    cost2 = cost * cost
    sint = torch.sqrt(torch.clamp_min(1.0 - cost2, 0.0))
    if p.stokes:
        # the line's scattering matrix; the azimuth by rejection
        S22 = 0.75 * E1 * (cost2 + 1.0)
        S11 = S22 + E2
        S12 = 0.75 * E1 * (cost2 - 1.0)
        S33 = 1.5 * E1 * cost
        S44 = 1.5 * E3 * cost
        acc_phi, phi = azimuth_rounds(
            s, S12 / torch.clamp_min(S11, TINY),
            uniforms(seed, STREAM_SCATTER, lanes, counter,
                     range(p.rounds + 2, 2 * p.rounds + 2)))
        acc = acc & acc_phi
    else:
        phi = samplers.TWOPI * xi[1]
    do_res = is_res & acc
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    phi2 = samplers.TWOPI * xi[2]
    boost = torch.zeros_like(s.xfreq)
    if p.core_skip != CORE_SKIP_OFF:
        xcrit, xcrit2 = local_xcrit(s, p)
        boost = torch.where(torch.abs(s.xfreq) < xcrit, xcrit2, boost)
    uxy = torch.sqrt(boost - torch.log(xi[3]))
    ux = uxy * torch.cos(phi2) * red.perp
    uy = uxy * torch.sin(phi2) * red.perp
    xfreq_new = xfreq_atom + uz * cost + (ux * cosp + uy * sinp) * sint
    if p.recoil:
        # (g0 / D)(1 - cos theta), g0 / D an f32 division (engine.py:2228)
        g0 = torch.as_tensor(red.g0, dtype=torch.float32, device=s.device)
        xfreq_new = xfreq_new - (g0 / torch.full((), p.Dfreq,
                                                 device=s.device)) \
            * (1.0 - cost)
    tau_next = -torch.log(torch.clamp_min(u[p.rounds + 1, 0], 1e-12))

    turned = ('kx', 'ky', 'kz') + (('mx', 'my', 'mz', 'nnx', 'nny', 'nnz',
                                    'Q', 'U', 'V') if p.stokes else ())
    if p.stokes:
        new = stokes_turn(s, cost, sint, cosp, sinp, S11, S12, S22, S33, S44)
    else:
        new = rotate_direction(s.kx, s.ky, s.kz, cost, sint, cosp, sinp)
    dust_sc = absorbed = torch.zeros_like(at_sc)
    if p.dust:
        dust_sc, absorbed, dust_new = dust_event(s, tallies, p, seed,
                                                 counter, ud, is_dust, cosp,
                                                 sinp)
    kind = torch.where(do_res, EVENT_RESONANCE,
                       torch.where(dust_sc, EVENT_DUST, 0))

    if record is not None:
        # the event as the peel sees it: before the turn
        record.flag.copy_(kind.to(torch.int32))
        for f in turned:
            getattr(record, f).copy_(getattr(s, f))
        for f, v in (('xatom', xfreq_atom), ('ux', ux), ('uy', uy),
                     ('uz', uz)):
            getattr(record, f).copy_(v)
        if lc.per_lane_E:
            for f, v in (('E1', E1), ('E2', E2), ('E3', E3)):
                getattr(record, f).copy_(torch.where(do_res, v, 0.0))

    for name, v in zip(turned, new):
        cur = getattr(s, name)
        v = torch.where(do_res, v, cur)
        if p.dust and name in dust_new:
            v = torch.where(dust_sc, dust_new[name], v)
        cur.copy_(v)
    done = do_res | dust_sc | absorbed
    s.phase.copy_(torch.where(absorbed, DEAD,
                              torch.where(done, FLYING, s.phase))
                  .to(torch.int32))
    s.xfreq.copy_(torch.where(do_res, xfreq_new, s.xfreq))
    if p.dust and p.reduced_wgt:
        s.wgt.copy_(torch.where(dust_sc, s.wgt * p.albedo, s.wgt))
    s.tau_target.copy_(torch.where(done, tau_next, s.tau_target))
    s.tau_run.copy_(torch.where(done, torch.zeros_like(s.tau_run),
                                s.tau_run))
    tallies.nscatt_gas += torch.where(do_res, s.wgt,
                                      torch.zeros_like(s.wgt)).sum()
    tallies.nscatt_events += do_res.sum(dtype=torch.float32)


def dust_event(s: BatchState, tallies: Tallies, p: ScatterParams, seed: int,
               counter: int, ud, is_dust, cosp, sinp):
    """The dust branch of the plain scatter (engine.py:2270-2381) on the
    pre-scatter state: Jabs and nscatt_dust are tallied here; returns
    (scattered, absorbed, the scattered lanes' new direction, and with
    Stokes triad and Stokes vector, by field name)."""
    if p.reduced_wgt:
        absorbed = torch.zeros_like(is_dust)
    else:
        absorbed = is_dust & (ud[1] > p.albedo)
    dust_sc = is_dust & ~absorbed
    if p.dust == DUST_MUELLER:
        lanes = torch.arange(s.batch, dtype=torch.int64, device=s.device)
        D = p.dust_block
        um = uniforms(seed, STREAM_SCATTER, lanes, counter, D + 1)
        cost = pmueller.sample_cost(p.mueller, um[0], um[1], um[2])
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        S11, S12, S33, S34 = pmueller.interp_S(p.mueller, cost)
        accp, phi = azimuth_rounds(
            s, S12 / torch.clamp_min(S11, TINY),
            uniforms(seed, STREAM_SCATTER, lanes, counter,
                     range(D + 2, D + 2 + p.rounds)))
        dust_sc = dust_sc & accp
        new = mueller_turn(s, cost, sint, torch.cos(phi), torch.sin(phi),
                           S11, S12, S33, S34)
    else:
        cost = samplers.rand_henyey_greenstein(ud[2], p.hgg)
        sint = torch.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
        new = dict(zip(('kx', 'ky', 'kz'),
                       rotate_direction(s.kx, s.ky, s.kz, cost, sint, cosp,
                                        sinp)))
    # Jabs at the lab frequency of the lane's cell
    xlab = s.xfreq
    if p.vel is not None:
        f = p.flat(s)
        xlab = s.xfreq + (p.vel[0][f] * s.kx + p.vel[1][f] * s.ky
                          + p.vel[2][f] * s.kz)
    fx = torch.floor(div(xlab - p.xfreq_min, p.dxfreq))
    ina = (fx >= 0.0) & (fx < p.nxfreq)
    wab = s.wgt * (1.0 - p.albedo) if p.reduced_wgt else s.wgt
    absorbing = is_dust & (absorbed | p.reduced_wgt)
    zero = torch.zeros_like(s.wgt)
    tallies.Jabs.index_add_(0, torch.clamp(fx, 0, p.nxfreq - 1).long(),
                            torch.where(absorbing & ina, wab, zero))
    tallies.nscatt_dust += torch.where(is_dust, s.wgt, zero).sum()
    return dust_sc, absorbed, new


def mueller_turn(s: BatchState, cost, sint, cosp, sinp, S11, S12, S33, S34):
    """The triad and the Stokes vector after a Mueller dust scattering, by
    field name (engine.py:2309-2328): turned by phi about k and by theta in
    the (k, m) plane, not re-orthonormalized."""
    out = {}
    for a in 'xyz':
        m, n, k = (getattr(s, f) for f in ('m' + a, 'nn' + a, 'k' + a))
        p_ = cosp * m + sinp * n
        out['nn' + a] = cosp * n - sinp * m
        out['m' + a] = cost * p_ - sint * k
        out['k' + a] = sint * p_ + cost * k
    c2p = 2.0 * cosp * cosp - 1.0
    s2p = 2.0 * sinp * cosp
    Q0 = c2p * s.Q + s2p * s.U
    U0 = -s2p * s.Q + c2p * s.U
    I1 = torch.clamp_min(S11 + S12 * Q0, TINY)
    out['Q'] = (S12 + S11 * Q0) / I1
    out['U'] = (S33 * U0 + S34 * s.V) / I1
    out['V'] = (-S34 * U0 + S33 * s.V) / I1
    return out


def stokes_turn(s: BatchState, cost, sint, cosp, sinp, S11, S12, S22, S33,
                S44):
    """(k, m, n, Q, U, V) after the scattering: the triad turned by phi
    about k and by theta in the (k, m) plane, re-orthonormalized (k
    normalized, m := m - (m.k) k normalized, n = k x m), and the Stokes
    vector through the scattering matrix (engine.py:2231-2265)."""
    px = cosp * s.mx + sinp * s.nnx
    py = cosp * s.my + sinp * s.nny
    pz = cosp * s.mz + sinp * s.nnz
    mx = cost * px - sint * s.kx
    my = cost * py - sint * s.ky
    mz = cost * pz - sint * s.kz
    kx = sint * px + cost * s.kx
    ky = sint * py + cost * s.ky
    kz = sint * pz + cost * s.kz
    knorm = torch.rsqrt(kx * kx + ky * ky + kz * kz)
    kx, ky, kz = kx * knorm, ky * knorm, kz * knorm
    mk = mx * kx + my * ky + mz * kz
    mx, my, mz = mx - mk * kx, my - mk * ky, mz - mk * kz
    mnorm = torch.rsqrt(torch.clamp_min(mx * mx + my * my + mz * mz, TINY))
    mx, my, mz = mx * mnorm, my * mnorm, mz * mnorm
    nx = ky * mz - kz * my
    ny = kz * mx - kx * mz
    nz = kx * my - ky * mx
    cos2p = 2.0 * cosp * cosp - 1.0
    sin2p = 2.0 * sinp * cosp
    Q0 = cos2p * s.Q + sin2p * s.U
    U0 = -sin2p * s.Q + cos2p * s.U
    I1 = torch.clamp_min(S11 + S12 * Q0, TINY)
    return (kx, ky, kz, mx, my, mz, nx, ny, nz, (S12 + S22 * Q0) / I1,
            (S33 * U0) / I1, (S44 * s.V) / I1)


def scatter(state: BatchState, tallies: Tallies, p: ScatterParams,
            seed: int, counter: int, record=None) -> None:
    """Scatter every AT_SCATTER lane, in place: kernel K4 for a CUDA state,
    the plain version for a CPU state.  `record`, a PeelRecord of the
    batch's size, receives the events for the peel."""
    if state.device.type == 'cpu':
        scatter_plain(state, tallies, p, seed, counter, record)
        return
    kbuild.require_cuda('scatter_lya', tallies.nscatt_gas,
                        tallies.nscatt_events, tallies.Jabs,
                        tallies.nscatt_dust, state.x, *p.device_tensors(),
                        *(() if record is None else (record.flag,)))
    kbuild.check(kbuild.library().lart_scatter_lya(
        state.lane_pointers, None if record is None else record.pointers,
        state.batch, seed & 0xFFFFFFFF, counter & 0xFFFFFFFF,
        ctypes.byref(p.c_params(tallies)), kbuild.stream_of(state.x)),
        'scatter_lya')
    kbuild.LAUNCHES['scatter_lya'] += 1
