"""Run configuration: parameter registry + Fortran-namelist-compatible parser.

Mirrors the reference's params_type defaults and names
(reference: src/define.f90:209-544) so existing `*.in` input files work
unchanged: `Params.from_namelist('t1tau6.in')`.  Mode resolution
(reference: src/setup.f90:4-579 read_input / :748 setup_procedure) happens in
`resolve()`, which returns a frozen, fully-derived config consumed by the
trace-time kernel dispatch -- the TPU replacement for the reference's ~25
runtime procedure pointers.

The port's own copy of lart_tpu/config.py, which has no jax in it:
lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step;
tests/test_torch_config.py resolves every example through both and compares
the results field for field.  The one change: the Mueller-table branch of
resolve() reads the table through lart_tpu_torch/physics/mueller.py, a
numpy-only parse.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

from . import lines as lines_mod
from .constants import FOURPI, SPEEDC, UM2KM

NAN = float('nan')


def _isfinite(v: float) -> bool:
    return v == v and abs(v) != math.inf


@dataclasses.dataclass
class Params:
    """Input parameters. Field names follow the reference namelist keys."""
    # --- photon counts / bookkeeping
    nphotons: int = 100_000
    no_photons: float = 1e5          # namelist alias (float form)
    nprint: int = 10_000_000
    # reference MPI master-worker chunk size (run_simulation_mod.f90:30-64);
    # accepted for namelist compatibility, meaningless for the batch engine
    num_send_at_once: int = 100
    use_master_slave: bool = True
    iseed: int = 0
    luminosity: float = 1.0

    # --- medium temperature / turbulence
    temperature: float = 1e4
    temperature0: float = -999.0
    bturb: float = -999.0
    Dfreq0: float = -999.0
    voigt_a0: float = -999.0

    # --- line selection
    line_id: str = 'ly_alpha'
    fine_structure: bool = False
    HeI_coherent: bool = False
    include_deuterium: bool = False
    D_to_H_ratio: float = 1.5e-5

    # --- optical depth / column normalization (choose one)
    taumax: float = -999.0
    tauhomo: float = -999.0
    tau0: float = -999.0
    N_HImax: float = -999.0
    N_HIhomo: float = -999.0
    N_HI: float = -999.0
    N_gasmax: float = -999.0
    N_gashomo: float = -999.0

    # --- velocity field
    Vexp: float = 0.0
    Vx: float = 0.0
    Vy: float = 0.0
    Vz: float = 0.0
    Vpeak: float = 0.0
    rpeak: float = 0.0
    DeltaV: float = 0.0
    Vrot: float = 0.0
    rinner: float = 0.0
    velocity_type: str = ''
    velocity_alpha: float = 1.0
    q: float = 1.0
    Omega: float = 0.0

    # --- source
    source_geometry: str = 'point'
    source_rscale: float = 0.0
    source_rmax: float = -999.0
    source_zscale: float = 0.0
    sersic_m: float = 1.0
    Reff: float = 0.0
    xs_point: float = 0.0
    ys_point: float = 0.0
    zs_point: float = 0.0
    spectral_type: str = 'voigt'
    xfreq0: float = 0.0
    gaussian_sigma_vel: float = 12.843374
    gaussian_FWHM_vel: float = -999.0
    EW_line: float = 0.0
    f_line: float = 0.0
    comoving_source: bool = True
    line_prof_file: str = ''
    line_prof_file_type: int = 0
    star_file: str = ''
    emiss_file: str = ''

    # --- physics switches
    recoil: bool = False
    core_skip: bool = False
    core_skip_global: bool = False
    use_stokes: bool = False
    use_reduced_wgt: bool = False

    # --- geometry / symmetry
    xyz_symmetry: bool = False
    xy_symmetry: bool = False
    xy_periodic: bool = False
    z_symmetry: bool = False
    geometry: str = ''
    nx: int = 1
    ny: int = 1
    nz: int = 11
    nr: int = -999
    xmax: float = 1.0
    ymax: float = 1.0
    zmax: float = 1.0
    xmin: float = NAN
    ymin: float = NAN
    zmin: float = NAN
    rmin: float = -999.0
    rmax: float = -999.0
    density_rscale: float = -999.9
    density_zscale: float = -999.9
    density_alpha: float = 0.0
    cone_opening: float = 0.0
    distance2cm: float = -999.9
    distance_unit: str = ''
    cart_file: str = ''
    density_file: str = ''
    temperature_file: str = ''
    velocity_file: str = ''
    dens_file: str = ''
    temp_file: str = ''
    velo_file: str = ''
    use_cie_condition: bool = False

    # --- exoplanet atmosphere illumination (stellar_illumination.f90)
    stellar_limb_darkening: int = 2
    distance_star_to_planet: float = 0.0
    stellar_radius: float = 0.0

    # --- frequency grid
    xfreq_min: float = NAN
    xfreq_max: float = NAN
    nxfreq: int = 121
    velocity_min: float = NAN
    velocity_max: float = NAN
    nvelocity: int = 0
    wavelength_min: float = NAN
    wavelength_max: float = NAN
    nwavelength: int = 0
    intensity_unit: int = -999
    continuum_normalize: bool = True

    # --- dust
    hgg: float = 0.6761
    albedo: float = 0.3253
    cext_dust: float = 1.6059e-21
    DGR: float = 0.0
    scatt_mat_file: str = ''

    # --- H2
    h2_model: str = 'none'
    f_H2: float = 0.0
    h2_temperature: float = 1000.0
    h2_pure_absorption: bool = False
    h2_hi_width: bool = False
    h2_data_dir: str = ''

    # --- ly_beta band 2
    nxfreq_Ha: int = 0
    xfreq_max_Ha: float = 0.0
    ny_2gam: int = 101
    cext_dust_Ha: float = 3.801e-22
    albedo_Ha: float = 0.6741
    hgg_Ha: float = 0.4967

    # --- clump medium
    use_clump_medium: bool = False
    clump_radius: float = -1.0
    clump_N_clumps: float = -1.0
    clump_f_vol: float = -1.0
    clump_f_cov: float = -1.0
    clump_tau0: float = -1.0
    clump_NHI: float = -1.0
    clump_nH: float = -1.0
    clump_temperature: float = -1.0
    clump_sigma_v: float = 0.0
    save_clump_info: bool = False
    clump_fully_inside: bool = True
    clump_allow_overlap: bool = False
    clump_radius_profile: str = 'constant'
    clump_density_profile: str = 'constant'
    clump_number_profile: str = 'constant'
    clump_radius_alpha: float = 0.0
    clump_radius_r0: float = 0.0
    clump_density_alpha: float = 0.0
    clump_density_r0: float = 0.0
    clump_number_alpha: float = 0.0
    clump_number_r0: float = 0.0
    clump_radius_min: float = -1.0
    clump_radius_max_in: float = -1.0
    clump_profile_file: str = ''
    clump_input_file: str = ''

    # --- grid-backend selector alias: some reference inputs spell the
    # medium as par%grid_type ('cartesian'|'amr'|'clump') instead of the
    # use_amr_grid/use_clump_medium booleans (examples/jellyfish_rmhd)
    grid_type: str = ''

    # --- AMR grid
    use_amr_grid: bool = False
    amr_morton_order: bool = True   # Z-order leaves for gather locality
    amr_type: str = 'generic'       # 'generic' file or 'ramses' snapshot
    amr_snapnum: int = -999         # RAMSES output number (amr_type='ramses')
    amr_file: str = ''
    ionization_model: str = 'cie_formula'
    dust_model: str = 'global_dgr'
    emissivity_model: str = 'none'
    ion_model: str = 'none'
    metallicity_global: float = -1.0
    Z_ref: float = 0.0134
    f_ion_dust: float = 0.01

    # --- outputs
    base_name: str = ''
    out_file: str = ''
    out_merge: bool = False
    out_bitpix: int = 0
    file_format: str = 'hdf5'
    save_all: bool = False
    save_Jin: bool = True
    save_Jabs: bool = True
    save_Jmu: bool = False
    nmu: int = 11
    mu_min: float = -1.0
    dmu: float = 0.0
    save_backup: bool = False
    save_all_photons: bool = False
    save_input_grid: bool = False
    save_peeloff: bool = False
    save_peeloff_2D: bool = False
    save_peeloff_3D: bool = True
    save_radial_profile: bool = False   # radial I(+Stokes) profiles from
                                        # peel maps (always written when
                                        # peel is on; flag kept for
                                        # namelist parity, define.f90:524)
    save_sightline_tau: bool = False
    save_dust_scattered: bool = False
    sampling_method: int = 1
    f_composite: float = 0.5

    # --- mid-run checkpoint / resume (TPU extension of the reference's
    # out_merge run-granularity resume, write_output_rect.f90:74-241) and
    # observability hooks (SURVEY.md section 5 tracing/metrics)
    checkpoint_file: str = ''       # HDF5 path; '' disables
    checkpoint_every: int = 0       # chunks between checkpoints (0 = off)
    resume_checkpoint: bool = False  # load checkpoint_file before running
    metrics_file: str = ''          # JSONL per-chunk step metrics; '' off
    profile_dir: str = ''           # profiler trace dir; '' disables
    profile_chunks: int = 3         # chunks to trace when profiling

    # --- observers (arrays handled in instruments/observer.py)
    nobs: int = 0
    alpha: Tuple[float, ...] = ()
    beta: Tuple[float, ...] = ()
    gamma: Tuple[float, ...] = ()
    obsx: Tuple[float, ...] = ()
    obsy: Tuple[float, ...] = ()
    obsz: Tuple[float, ...] = ()
    nxim: int = 129
    nyim: int = 129
    dxim: float = -999.0
    dyim: float = -999.0
    distance: float = -999.0
    nside: int = -999
    inside_x: float = 0.0
    inside_y: float = 0.0
    inside_z: float = 0.0
    phase_angle: Tuple[float, ...] = ()
    inclination_angle: Tuple[float, ...] = ()
    position_angle: Tuple[float, ...] = ()
    rotation_center_x: float = NAN
    rotation_center_y: float = NAN
    rotation_center_z: float = NAN
    save_direc0: bool = False

    # --- in-medium mean-intensity / scattering-rate maps (the reference's
    # compile-time -DCALCJ/-DCALCP/-DCALCPnew switches, made runtime)
    calcJ: bool = False
    calcP: bool = False
    calcPnew: bool = False

    # --- TPU batch-engine knobs (new; no reference counterpart)
    batch_size: int = 1 << 17       # photon lanes per device
    fly_substeps: int = 8           # DDA cell-steps per jitted cycle
    scatter_rounds: int = 4         # rejection rounds per cycle
    chunk_cycles: int = 64          # cycles per host-side chunk call
    refill_every: int = 4           # refill dead lanes every N cycles
    # clump populations up to this size use the dense ray-vs-all-spheres
    # flight kernel ((B, N) broadcast, no gathers); larger ones fall back
    # to the CSR cell-stepping walker
    clump_dense_max: int = 1024
    # AMR trees whose finest virtual grid (2^levelmax)^3 stays under this
    # many voxels get a flattened point->cell lookup table (one gather per
    # traversal hop instead of neighbor + octant descent); 0 disables
    amr_fine_lookup_max: int = 34_000_000
    n_devices: int = 0              # 0 = all visible devices
    precision: str = 'f32'
    # disable the analytic-flight specializations (uniform slab/sphere)
    # and force the generic DDA kernel; A/B validation knob used by
    # tests/test_uniform_slab_fastpath.py and tools/acceptance.py
    force_generic_kernel: bool = False

    # ------------------------------------------------------------------
    @classmethod
    def from_namelist(cls, path_or_text: str) -> 'Params':
        """Parse a reference `&parameters ... /` namelist file or string."""
        try:
            with open(path_or_text) as fh:
                text = fh.read()
        except (OSError, ValueError):
            text = path_or_text
        p = cls()
        fields = {f.name: f for f in dataclasses.fields(cls)}
        lower = {k.lower(): k for k in fields}
        array_rx = re.compile(r'^([a-zA-Z_0-9]+)\s*\(\s*(\d+)\s*\)$')
        arrays: dict = {}
        seen: set = set()
        assign_rx = re.compile(
            r"par\s*%\s*([a-zA-Z_0-9()\s]+?)\s*=\s*"
            r"('[^']*'|\"[^\"]*\"|[^\s,]+(?:\s*,\s*[^\s,]+)*?)"
            r"(?=\s+par\s*%|\s*,?\s*$|\s*$)")
        for raw in text.splitlines():
            stmt = raw.split('!')[0].strip()
            if not stmt or stmt.startswith('&') or stmt == '/':
                continue
            matches = list(assign_rx.finditer(stmt))
            if not matches:
                continue
            for m in matches:
                key, val = m.group(1).strip(), m.group(2).strip()
                cls._apply_assignment(p, fields, lower, array_rx, arrays,
                                      seen, key, val)
        for base, items in arrays.items():
            k = lower.get(base)
            if k is None:
                raise KeyError(f'unknown array parameter: par%{base}')
            n = max(items)
            vals = [items.get(i + 1, 0.0) for i in range(n)]
            setattr(p, k, tuple(float(v) for v in vals))
        # no_photons alias (reference setup.f90 mirrors it into nphotons)
        if 'no_photons' in seen and 'nphotons' not in seen:
            p.nphotons = int(round(p.no_photons))
        return p

    @classmethod
    def _apply_assignment(cls, p, fields, lower, array_rx, arrays, seen,
                          key, val):
        am = array_rx.match(key)
        if am:
            base, idx = am.group(1), int(am.group(2))
            arrays.setdefault(base.lower(), {})[idx] = _parse_scalar(val)
            return
        k = lower.get(key.lower())
        if k is None:
            raise KeyError(f'unknown parameter: par%{key}')
        setattr(p, k, _coerce(_parse_scalar(val), fields[k].type,
                              getattr(p, k)))
        seen.add(k)

    def resolve(self) -> 'ResolvedConfig':
        return resolve(self)


def _parse_scalar(val: str):
    v = val.strip().rstrip(',').strip()
    if (v.startswith("'") and v.endswith("'")) or (v.startswith('"') and v.endswith('"')):
        return v[1:-1]
    lv = v.lower()
    if lv in ('.true.', 't', 'true'):
        return True
    if lv in ('.false.', 'f', 'false'):
        return False
    v2 = lv.replace('d', 'e')
    try:
        f = float(v2)
    except ValueError:
        return v
    return f


def _coerce(value, ftype, default):
    if isinstance(default, bool):
        return bool(value)
    if isinstance(default, int) and not isinstance(value, str):
        return int(round(float(value)))
    if isinstance(default, float) and not isinstance(value, str):
        return float(value)
    if isinstance(default, tuple):
        if isinstance(value, (int, float)):
            return (float(value),)
        return value
    return value


# ---------------------------------------------------------------------------
# Resolved (derived) configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolvedConfig:
    """Fully-derived static configuration: inputs + line data + derived modes.

    Everything here is a Python-level constant at trace time; jitted kernels
    specialize on it (the TPU analogue of setup_procedure's pointer wiring).
    """
    par: Params
    line: lines_mod.Line
    vtherm: float                 # total b-parameter at reference T [km/s]
    Dfreq_ref: float              # reference Doppler width [Hz]
    voigt_a_ref: float            # damping parameter at reference T
    # grid geometry (reference grid_mod_car.f90:75-196)
    dx: float
    dy: float
    dz: float
    xmin: float
    ymin: float
    zmin: float
    i0: int
    j0: int
    k0: int
    # boundary conditions per axis: 'escape' | 'periodic' | 'reflect'
    bc_x: str = 'escape'
    bc_y: str = 'escape'
    bc_z: str = 'escape'

    @property
    def nx(self): return self.par.nx
    @property
    def ny(self): return self.par.ny
    @property
    def nz(self): return self.par.nz


def vtherm_total(par: Params, line: lines_mod.Line, T: float) -> float:
    """b_tot = sqrt(vtherm1^2 T + bturb^2)  [km/s] (define.f90:928-933)."""
    vt = line.vtherm1 * math.sqrt(T)
    if par.bturb > 0.0:
        vt = math.sqrt(vt * vt + par.bturb * par.bturb)
    return vt


def resolve(par: Params) -> ResolvedConfig:
    """Normalize geometry and derive the static mode configuration.

    Mirrors read_input's geometry normalization (setup.f90:60-145).
    """
    line = lines_mod.get_line(par.line_id, par.fine_structure,
                              par.include_deuterium)

    # distance_unit -> distance2cm (setup.f90:469-485): only when the
    # user did not set distance2cm explicitly; unknown units mean kpc
    if par.distance2cm < 0.0:
        from .constants import AU2CM, KPC2CM, PC2CM
        unit = par.distance_unit.strip().lower()
        d2cm = {'kpc': KPC2CM, 'pc': PC2CM, 'au': AU2CM,
                '': 1.0}.get(unit, KPC2CM)
        par = dataclasses.replace(par, distance2cm=d2cm)

    # grid_type alias -> backend booleans
    gt = par.grid_type.strip().lower()
    if gt in ('amr', 'octree'):
        par = dataclasses.replace(par, use_amr_grid=True)
    elif gt in ('clump', 'clumpy'):
        par = dataclasses.replace(par, use_clump_medium=True)
    elif gt not in ('', 'cartesian', 'car', 'uniform'):
        raise ValueError(f'unknown grid_type: {par.grid_type!r}')

    # output backend must be a known one (the reference errors on unknown
    # par%file_format rather than silently substituting, iofile_mod.f90:81)
    from .io.iofile import detect_format
    detect_format('', par.file_format)

    # interior (HEALPix) observer vetoes (setup.f90:169-250: no clump,
    # no ly_beta, no Stokes all-sky maps)
    if par.nside > 0:
        if par.use_clump_medium:
            raise ValueError('nside>0 (HEALPix inside observer) is not '
                             'supported with clump mode')
        if line.line_type == 8:
            raise ValueError('ly_beta: inside-observer (HEALPix) not '
                             'supported')
        if par.use_stokes:
            raise ValueError('use_stokes with an inside (HEALPix) observer '
                             'is not supported')

    # Ly-beta (line_type=8) mode vetoes and forced flags
    # (setup.f90:239-287)
    if line.line_type == 8:
        if par.use_clump_medium:
            raise ValueError('ly_beta: clump medium not supported')
        if par.use_stokes:
            raise ValueError('ly_beta: Stokes polarization not supported')
        if par.xyz_symmetry or par.xy_symmetry or par.xy_periodic:
            raise ValueError('ly_beta: xyz/xy symmetry and xy_periodic '
                             'not supported')
        if par.geometry.strip().lower() in ('plane_atmosphere',
                                            'spherical_atmosphere'):
            raise ValueError('ly_beta: atmosphere geometries not supported')
        if par.core_skip:
            # core-skip would bias the 3p->2s conversion rate
            # (setup.f90:287)
            par = dataclasses.replace(par, core_skip=False)

    # Mueller-matrix dust table: an explicit scatt_mat_file (or, for
    # Stokes+dust runs, the bundled table nearest in wavelength) overrides
    # albedo/hgg/cext_dust (setup_scattering_matrix, setup.f90:581-649)
    if par.DGR > 0.0 and (par.scatt_mat_file.strip() or par.use_stokes):
        from .physics.mueller import default_mueller_file, load_mueller
        mpath = par.scatt_mat_file.strip() or \
            default_mueller_file(line.wavelength0)
        if mpath:
            mmeta, _ = load_mueller(mpath)
            par = dataclasses.replace(par, albedo=mmeta.albedo,
                                      hgg=mmeta.hgg, cext_dust=mmeta.cext,
                                      scatt_mat_file=mpath)

    # geometry defaults: sphere sets rmax, slab uses z extent
    geom = par.geometry.strip().lower()
    if geom == 'sphere' and par.rmax <= 0.0:
        par = dataclasses.replace(par, rmax=min(par.xmax, par.ymax, par.zmax))

    # source radial extent defaults to the system extent
    # (setup.f90:427-436: source_rmax <- rmax, falling back to the box
    # half-size when rmax is unset -- exponential_* and sersic/ssh
    # samplers divide by it)
    if par.source_rmax < 0.0:
        srm = par.rmax if par.rmax > 0.0 \
            else min(par.xmax, par.ymax, par.zmax)
        par = dataclasses.replace(par, source_rmax=srm)

    # SSH galaxy model (Song, Seon & Hwang 2020): exponential (m=1)
    # Sersic with Reff fixed by the scale length (setup.f90:461-466)
    if par.source_geometry.strip().lower() == 'ssh':
        par = dataclasses.replace(
            par, sersic_m=1.0,
            Reff=1.67834607093866 * par.source_rscale)

    # symmetric box centered at origin unless symmetry folds it
    def axis(nmax, n, sym):
        if sym:
            if n % 2 == 0:
                d = nmax / n
                amin, a0 = 0.0, 1
            else:
                d = nmax / (n - 0.5)
                amin, a0 = -d / 2.0, 2
        else:
            d = 2.0 * nmax / n
            amin, a0 = -nmax, 0
        return d, amin, a0

    xsym = par.xyz_symmetry or par.xy_symmetry
    ysym = par.xyz_symmetry or par.xy_symmetry
    zsym = par.xyz_symmetry
    dx, xmin, i0 = axis(par.xmax, par.nx, xsym)
    dy, ymin, j0 = axis(par.ymax, par.ny, ysym)
    dz, zmin, k0 = axis(par.zmax, par.nz, zsym)

    if geom == 'plane_atmosphere':
        # exoplanet 1-D plane-parallel atmosphere: z from zmin (or 0) to
        # zmax; photons exiting the bottom are destroyed by the molecular
        # layer -> Jabs2 (grid_mod_car.f90:151-167,1181-1185)
        zmin = par.zmin if _isfinite(par.zmin) else 0.0
        dz = (par.zmax - zmin) / par.nz
        k0 = 0
    if geom == 'spherical_atmosphere' and par.rmax <= 0.0:
        par = dataclasses.replace(
            par, rmax=min(par.xmax, par.ymax, par.zmax))

    bc_x = 'periodic' if par.xy_periodic else ('reflect' if xsym else 'escape')
    bc_y = 'periodic' if par.xy_periodic else ('reflect' if ysym else 'escape')
    bc_z = 'reflect' if zsym else 'escape'

    vtherm = vtherm_total(par, line, par.temperature)
    Dfreq_ref = vtherm / (line.wavelength0 * UM2KM)
    voigt_a_ref = (line.damping / FOURPI) / Dfreq_ref

    return ResolvedConfig(
        par=par, line=line, vtherm=vtherm, Dfreq_ref=Dfreq_ref,
        voigt_a_ref=voigt_a_ref,
        dx=dx, dy=dy, dz=dz, xmin=xmin, ymin=ymin, zmin=zmin,
        i0=i0, j0=j0, k0=k0, bc_x=bc_x, bc_y=bc_y, bc_z=bc_z)
