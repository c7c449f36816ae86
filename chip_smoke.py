#!/usr/bin/env python3
"""Smoke test of lart_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, runs the slab, the uniform
sphere, the expanding Hubble sphere, the dusty expanding shell, the metal
lines (line types 2, 4-7), Ly-beta with its H-alpha band (line type 8),
H2 pumping of Ly-alpha, the octree AMR grid and the clump media end to end
through the driver and the CLI, without and with peel-off images
(Stokes), the interior all-sky observer with its HEALPix maps and the
sight-line tau maps (CIV_test.in, the standalone sightline tool), the
volume and table sources, the per-cell temperature with the 3-D
density cubes (AlII_ex.in, FeII_turb, Prochaska), and exoplanet
atmospheres lit by the illumination sources (star_planet_a090.in,
wasp52b_like.in), the TIGRESS shearing box (shear.in) and the CALCJ/
CALCP/CALCPnew maps, and the run over several ranks (NCCL, gloo), and
measures their steady-state rates.

    python3 chip_smoke.py            # every phase, needs one CUDA device
    python3 chip_smoke.py --phases 0,1,2

Phases (one line each, or more):
  0  card name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  1  build K1-K11 from lart_tpu_torch/csrc with nvcc (one per source, in
     parallel); print each instance's registers
  2  each kernel and branch against its plain version on the card at
     B = 131072: K1-K4 on the flagship slab; K5 on the 201^3 Hubble grid of
     examples/vel_effect/t4NHI2_20_V0200.in (reflect, moving) and on the
     slab with force_generic_kernel (periodic); K6 on the 129^3 sphere of
     examples/sphere/t4tau7.in; K4 core-skip, local and global, on that
     sphere, and local on the Hubble grid; K2 in the moving medium; K7
     (direct and resonance) on the grids of the three peel-off examples as
     written (slab_peel: the periodic slab walk with Stokes; sphere_peel:
     the chord, with and without Stokes; vel_effect_peel: the 201^3 walk
     in the Hubble flow), K4's Stokes branch with its peel record
     (sphere_peel, slab_peel with core-skip) and K2's birth triad and
     launch flags; K7 where its deposits crowd (phase2_peel_hot: every
     lane at one point of the slab_peel grid with dust, Stokes and two
     observers, in modes direct, resonance and dust, and a thick state
     whose pairs deposit 0; PEEL_STELLAR on a090 on +z into 64 bins) and
     where it packs its walks (peel_packed: a quarter of the lanes
     flagged on slab_peel and CIV_test's interior grid, two calls each);
     dust on the 201^3 grid of examples/DL2008/DL20e_dust.in
     as written, with and without Stokes: K5 with rhokapD, K2's Gaussian
     births, K4's dust branch (HG, Mueller +- use_reduced_wgt) with its
     peel record, K7 in mode dust; the metal lines (line_cases) on the
     grids of examples/SiII_1193/tau1e+2_V200.in, SiII_1527/
     t1e5tau1e1_V050.in, FeII_test/FeII_UV1.in, HeI_sphere/t4tau2.in,
     HeI_coherent_test/pt_tau100_coh.in and lya_HD/
     sphere_HD_dijkstra2006.in as written and in variants (the Mg II
     doublet on their grids, geometry sphere for the K6 and K7 chord
     branches, 1x1x201 slabs for K3): K2 continuum and branch_init_shift
     (types 2, 4, 5, 6), the line profile in K3, K5, K6 (types 2, 5, 7),
     K4 types 2, 4, 5, 6, 6 coherent, 7 +- recoil with the peel record, K7
     type 5 direct and resonance, walk and chord, +- Stokes, recoil;
     Ly-beta and H2 (phase2_lyb_h2) on the 101^3 grids of
     examples/ly_beta_sphere/t4tau1e4.in, t4tau1e4_dust.in and
     h2_test/h2_on.in as written (an observer added to h2_on) and of
     sphere_HD_dijkstra2006 with H2: K2's band, K5 with the H-alpha band
     (+- dust) and with H2, K4's conversions (+- recoil), the H-alpha
     band's dust events and the H2 branch (line types 1 and 7), K7's
     conversion, resonance and H-alpha dust peels and the H2 sightline;
     the AMR backend (phase2_amr); the clump backend (phase2_clump): K9 on
     examples/clump_sphere/clumps_overlap.in as written (overlap mode), in
     non-overlap mode, with clump_sigma_v and clump_temperature 9e4 (dust,
     Stokes), in Mg II (kMulti); K10 on that population with
     clump_dense_max 0 (overlap form), on examples/bicone/bicone_clump.in
     (non-overlap) and on the 1.48M-clump population (FCOV1); K9 on 1000
     overlapping clumps whose rays cross more chords than its list holds
     (MANY_CHORDS); K2's clump births, K4's owner draw and clump frame,
     K7's clump sightline; the interior observer and the sight-line maps
     (phase2_inside): K7's interior mode (HEALPix pixel, capped sightline)
     on examples/healpix_CIV/CIV_test.in's 101x101x51 grid with save_peeloff
     on (the slice's main path), on the sphere_peel grid (chord), the 48k
     AMR sphere and the DL20e_dust shell (dust peel); K11 on CIV_test's
     whole nside-64 map (6.05M rays), on sightline_car.in as written, on
     the 201^3 Hubble grid (TAN and interior), the AMR sphere,
     clumps_overlap.in and the 1.48M-clump population; K2's
     exponential-cylinder births on CIV_test's grid, the Hubble grid and
     the AMR sphere; the volume and table sources (phase2_sources): K2's
     volume instance on examples/HeI_sphere_cont/t4tau2.in as written
     (uniform_sphere, continuum), with voigt0 and continuum+gaussian, a
     point source with voigt0, and every analytic geometry on the 201^3
     grid of vel_effect/t4NHI2_20_V0200.in (xyz_symmetry); the radial
     instance on SSH_MUSE/halo_0053.in as written (ssh), exponential_sphere
     and a sersic m = 4; the alias instance on many_stars/stars1.in as
     written, density1/density2 on a 65^3 cut of halo_0053, the jellyfish
     leaves' emissivity and a 205^3 = 8.6M-cell table; the per-cell
     temperature (phase2_temperature): on emiss_1D_AlII/AlII_ex.in as
     written (the slice's main path: its 1-D temperature profile) K2's
     alias instance, K5, K4 (+- local core-skip), K7 and K11 at each cell's
     a and D, on the 201^3 Hubble grid with a 1e3-1e5 K temperature cube in
     Mg II (the kMulti instances, with an observer: K2's point instance,
     K5, K4, K7, K11) and on h2_on.in's grid with that cube (kH2: K2, K5,
     K4), and jellyfish_pt's leaves at their own temperature in Mg II and
     with H2 (K8's kMulti and kH2 instances, K2, K4, K7); the atmospheres
     and illuminations (phase2_atmosphere): on star_planet_a090.in as
     written (the slice's main path) K2's illumination instance with the
     line_prof_file spectrum and the limb record, K5's masked core (moving,
     per-cell T), K7's mask walk and PEEL_STELLAR in the namelist's
     orientation and on +z, K2's point instance with line_prof_file; on
     wasp52b_like.in K2 stellar, K5, PEEL_STELLAR on +z and the mask walk
     at tau 1e4, plane_illumination's disk; a 1x1x201 plane atmosphere
     (K2's plane_illumination, K5's bottom face, a 1-D emissivity profile
     in the alias instance); point_illumination; stellar births and
     PEEL_STELLAR on the AMR sphere and on clumps_overlap.in; the
     shearing box and the maps (phase2_shear): K5's shear wrap on
     tigress_shear/shear.in as written (lanes next to both x faces) and
     K2's unsheared births there, K5's J1 and Pnew deposits and K4's Pa
     deposit on t1tau6.in and t4tau7.in as written and a 65^3 box (the
     three binning geometries; t4tau7 with calcP alone on K6), the maps
     within 1e-5 of their largest bin, and one 32-cycle chunk against
     its cycles flushed one at a time (the f64 maps' worst bin); the
     all-photons table (phase2_allph): the birth rows of K2's five
     instances compared by id, the death rows of K4's four instances with
     the table, K5 with and without it (t4tau7, DL20e_dust with Stokes,
     shear.in, a plane atmosphere, a090's masked core), K8 on amr_sphere,
     K9 on clumps_overlap, K10 on bicone_clump
  3  driver.run on cuda and on cpu, statistics agree: the tau0 = 100 slab,
     a 33^3 tau0 = 100 uniform sphere, a 33^3 xyz-symmetric Hubble sphere
     (Vexp 200 km/s, tau0 = 100); with peel-off to two observers, a 17^3
     tau0 = 100 uniform sphere with Stokes and a 17^3 Hubble sphere without;
     the 17^3 dusty shell of testing.dust_params with Mueller dust, Stokes
     and one observer (absorbed weight, spectra, scatterings, peel); 17^3
     spheres of the Mg II doublet, the Si II multiplet (Stokes, recoil, one
     observer) and H + D Ly-alpha (testing.line_params); a 17^3 Ly-beta
     sphere with dust and one observer, and a 17^3 H2 sphere; the AMR
     sphere and jellyfish_pt; the 40-clump sphere of testing.clump_params
     in its dense (K9) and CSR (K10) forms, one population in both runs;
     an interior observer at the centre of a 17^3 shell with
     save_sightline_tau (the all-sky map's isotropy, the tau maps).  Its
     own spawned process runs it beside phase 4: its CPU runs take one
     core, phase 4's launch-bound runs on the card another
  4  the main paths through the CLI (lart_tpu_torch.__main__.main), FITS
     output, launch counts read around each run: examples/slab/t1tau6.in
     (tauhomo 3e3, 5e4 photons, B = 131072); examples/sphere/t4tau7.in cut to the
     Dijkstra acceptance case (taumax 1e5, 1e4 photons; shape chi2/dof,
     peak position, W_esc); examples/vel_effect/t4NHI2_20_V0200.in at its
     201^3 grid cut to N_HI 5e17 and 1e4 photons (W_esc + W_oor); the
     peel-off examples as written but for their photons: slab_peel 1e4
     at taumax 3e3, sphere_peel 2e4 at taumax 2e3 (flux closure),
     vel_effect_peel at N_HI
     5e17 and 1e4 photons (weight, and the _peel3D files);
     examples/DL2008/DL20e_dust.in and DL20e.in as written but for their
     photons and N_HI 1e18 and 2e17 (DL20e_dust with DGR 100: the dust's
     tau as written) (W_esc + W_abs + W_oor, the
     absorbed share, a red-dominated spectrum); the metal lines:
     SiII_1193/tau1e+2_V200.in as written (W_esc + W_oor, the Si II*
     fluorescent lines above the continuum, the _peel3D file),
     sphere_HD_dijkstra2006.in with its photons cut to HD_PHOTONS and N_HI
     to HD_NHI,
     HeI_sphere/t4tau2.in and SiII_1527/t1e5tau1e1_V050.in as written;
     ly_beta_sphere/t4tau1e4.in and t4tau1e4_dust.in as written and
     h2_test/h2_on.in at taumax 1e4 (the band budgets, P_down[1], Jout_Ha
     and peel_Ha; the H2 budget and keywords); the AMR examples (amr_runs);
     clumps_overlap.in as written, through K10 (clump_dense_max 0: the
     <N_scatt> ratio K10 / K9 held at 1 +- 5%) and with one observer on +z,
     and bicone_clump.in with save_clump_info off (W_esc + W_oor = 1);
     CIV_test.in with save_peeloff (1e5 photons: <N_scatt> beside RUNLOG's
     14.54, the _peel3D/_peel2D HEALPix maps with NSIDE 64, the _tau
     file) and the sightline tool on both examples/sightline_tau inputs
     (N_gas against the analytic chord of their sphere); the volume and
     table sources (sources_cli, testing.SOURCE_CASES): t4tau2.in and
     HeI_coherent_test/un_tau100_coh.in as written, stars1.in cut to 2e4
     photons and taumax 3e3, halo_0053.in cut to taumax 1e4,
     jellyfish_emiss.in to 3e3 (the weight budget against the birth
     weights, <N_scatt>); the per-cell temperature and the 3-D cubes
     (temperature_cli): AlII_ex.in as written (the budget against the
     birth weights summed on the device, <N_scatt> beside lart_tpu's CPU
     run, the _peel3D and _tau files), FeII_turb/FeII_UV1_V100.in with its
     65^3 turbulent cube as FITS and photons cut, Prochaska/MgII_a.in with
     its 150^3 gz-FITS cube and photons cut, jellyfish_pt's leaves in
     Mg II cut to taumax 1e3; the atmospheres (atmosphere_cli):
     star_planet_a090.in and wasp52b_like.in as written (the budget
     W_esc + W_abs2 + W_oor against the birth weights summed on the
     device; <N_scatt>, the Jabs2 share and the normalized flux factor
     beside lart_tpu's CPU runs, tools/atmosphere_cpu_runs.py, within 5%
     or 3 sigma), a090 with its observer on +z and Direct0 (Direct <=
     Direct0 in every bin, the transit depth beside lart_tpu's) and a
     1x1x32 plane atmosphere lit by plane_illumination; the shearing box
     and the maps (shear_cli): shear.in as written (W_esc + W_oor
     against the births summed on the device, <N_scatt> and the Jout rms
     beside lart_tpu's CPU run, tools/shear_cpu_runs.py), t1tau6.in at
     tauhomo 1e4 and t4tau7.in at taumax 1e3 with calcJ, calcP and
     calcPnew (their FITS sections, the slab's Pa closure, each map by
     chi2/dof < 3 beside lart_tpu's CPU runs); save_all_photons
     (allph_cli): t4tau7.in at taumax 1e4 (1e5 photons) through K5,
     DL20e_dust.in at its cut with Stokes, amr_sphere.in, clumps_overlap.in
     and bicone_clump.in (the AllPhotons section read back, the table's
     closures, <nscatt_gas> and the histograms of xfreq1, xfreq2 and rp
     beside lart_tpu's CPU runs, tools/allph_cpu_runs.py)
  5  steady-state rates, B = 131072, budget 1e9 so the batch never drains:
     the flagship slab (tau0 = 1e6, nz = 201, chunk_cycles 32; >= 800
     chunks and >= 1 s),
     then one window of >= 1 s each of t4tau7 as written, vel_effect V0200
     as written, the flagship slab through K5 (force_generic_kernel), and
     the three peel-off examples as written, DL20e_dust as written and with
     one observer on +z, SiII_1193/tau1e+2_V200 with its observer,
     sphere_HD_dijkstra2006 and HeI t4tau2 as written, t4tau1e4 with its
     observer and h2_on as written, the AMR cells, clumps_overlap.in,
     bicone_clump.in, the 1.48M-clump population and clumps_overlap.in
     with one observer on +z, CIV_test.in with save_peeloff (and K11's ms
     for one whole nside-64 map), t4tau2.in, stars1.in and halo_0053.in as
     written (K2's volume, alias and radial instances), AlII_ex.in as
     written (the per-cell instances, and K11's ms for its whole map),
     jellyfish_pt in Mg II (K8's kMulti instance per leaf),
     star_planet_a090.in and wasp52b_like.in as written (photons/s too; K2's
     illumination instance, K5's atmosphere branches, PEEL_STELLAR with its
     in-image pairs, as written and on +z), shear.in as written (K5's
     shear instance) and t1tau6.in as written with the three maps (K5's
     deposits, K4's Pa), t4tau7.in as written with save_all_photons (a
     budget of 1e7: K5's, K2's and K4's kAllph instances) beside
     t4tau7.in as written, and short windows of amr_sphere.in,
     clumps_overlap.in and bicone_clump.in with the table; a torch.profiler
     breakdown of
     each; each kernel's device time against its plain version's at the
     steady-state shapes, beside its bound
  6  several ranks (phase6): t4tau7.in cut to taumax 1e3 and 2e4 photons
     with the table and one observer through parallel/launch.run_ranks at
     one rank over NCCL (launch counts, the all-reduce's among them) and
     through driver.run in a one-rank NCCL group in this process, each of
     its chunk all-reduces, drain shrinks and end reduces bit for bit the
     single-rank path on the same inputs; flagship windows in turns,
     reduced and plain; the all-reduce's ms on the flagship's buffer
     against the host and gloo route, beside its bound; two gloo ranks
     sharing the card on the same config (the drain's 512 rung crossed
     with both ranks alive, every photon launched, every table id written
     by one rank, <nscatt_gas>, Jout and the peel flux beside the one-rank
     run)
Any failure raises and exits non-zero.  Before the last line it prints one
JSON object with the kernels of the main paths, and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
It imports neither jax nor h5py.
"""

import argparse
import dataclasses
import json
import math
import multiprocessing
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B_MAIN = 131072
SLEEP_CYCLES = 20_000_000     # ~10 ms of GPU clock: covers 20 launches
FLAGSHIP_CHUNKS = 800         # the flagship's window: at least this many chunks
SPREAD_CHUNKS = 80
WINDOW_S = 1.0                # the shortest timed window of the other cells
LANE_RTOL, LANE_ATOL, MAX_FRAC = 1e-5, 1e-6, 1e-4
HBM_BYTES_S = 3.35e12         # H100 SXM device memory, bytes/s
F32_FLOP_S = 67e12            # H100 SXM f32 outside the tensor cores, flop/s
PEEL_EXAMPLES = {'slab_peel': 'slab_peel/t1tau4.in',
                 'sphere_peel': 'sphere_peel/t4tau4_peel.in',
                 'vel_effect_peel': 'vel_effect_peel/t4NHI2_20_V0200_peel.in'}
DL20E_DUST, DL20E = 'DL2008/DL20e_dust.in', 'DL2008/DL20e.in'
DL_PHOTONS = 5000             # phase 4's cut of the DL2008 examples
# one external observer on the +z axis; DL20e_dust.in sets its 129 x 129
# image
OBSERVER = dict(save_peeloff=True, nobs=1, distance=1e3, alpha=(0.0,),
                beta=(0.0,))
# the metal-line examples (line types 2, 4-7): the slice's main path is
# SiII_1193 (type 5, fluorescent, continuum, recoil, Stokes, one observer)
LINE_EXAMPLES = {'SiII_1193': 'SiII_1193/tau1e+2_V200.in',
                 'SiII_1527': 'SiII_1527/t1e5tau1e1_V050.in',
                 'FeII_UV1': 'FeII_test/FeII_UV1.in',
                 'HeI': 'HeI_sphere/t4tau2.in',
                 'HeI_coherent': 'HeI_coherent_test/pt_tau100_coh.in',
                 'HD': 'lya_HD/sphere_HD_dijkstra2006.in'}
# the Mg II 2796/2803 doublet (type 2) on a grid of the Si II examples
MGII = dict(line_id='MgII_2796', wavelength_min=2790.0,
            wavelength_max=2810.0)
# phase 4's cut of sphere_HD_dijkstra2006: as written (N_HI 1.2e19) each
# photon scatters ~8e5 times, one scattering a cycle, and 2000 photons took
# 205 s on the card whatever their number; N_HI 3e17 cut that ~fortyfold
# (13-17 s), 1e17 cuts it to ~5 s (testing.SOURCE_CASES['sphere_HD_cut'])
HD_PHOTONS, HD_NHI = 2000, '1e17'
# phase 4's cuts of slab/t1tau6.in at tauhomo 3e3 (1e5 photons as written;
# tauhomo 1e4 took 25-27 s: testing.SOURCE_CASES['t1tau6_cut']) and of the
# Dijkstra case (2e4 photons took 66-91 s by the host)
SLAB_PHOTONS, DIJKSTRA_PHOTONS = 5e4, 10000
LINES = ' (line types 2, 4-7)'  # the kernels' metal-line instances in res
# Ly-beta with its H-alpha band (line type 8) and H2 pumping of Ly-alpha:
# the slice's examples, and the names of their kernel branches in res
LYB, LYB_DUST = 'ly_beta_sphere/t4tau1e4.in', 'ly_beta_sphere/t4tau1e4_dust.in'
H2_ON = 'h2_test/h2_on.in'
LT8, H2 = ' (line type 8)', ' (H2)'
# the octree AMR backend (K8 and the AMR branches of K2, K4, K7): the
# slice's examples, the base of make_amr_sphere's 3.06M-leaf sphere, phase
# 4's cut of jellyfish_pt (tau_pole 2.9e7 as written: a long drain tail),
# and the names of the AMR branches in res
AMR_SPHERE, JELLY = 'amr_sphere/amr_sphere.in', 'jellyfish_rmhd/jellyfish_pt.in'
AMR_BIG, JELLY_TAU, AMR = 128, 3e3, ' (AMR)'
# the clump backend (K9, K10 and the clump branches of K2, K4, K7): the
# slice's examples, the population at the scale of the reference's
# clump_fcov1 run (R 1, f_cov 1, radius 9.5e-4, N_HI 1e18: 1,477,378 clumps
# on a 192^3 CSR grid), and the names of the clump branches in res
CLUMPS_OVERLAP, BICONE = ('clump_sphere/clumps_overlap.in',
                          'bicone/bicone_clump.in')
FCOV1 = dict(clump_N_clumps=-1.0, clump_f_cov=1.0, clump_radius=9.5e-4,
             clump_tau0=-1.0, clump_NHI=1e18)
CLUMP = ' (clump)'
# the interior all-sky observer, the sight-line maps and the exponential
# cylinder source: the slice's main path CIV_test.in (the repo's only
# all-sky example, run with save_peeloff on), the standalone sightline
# tool's two examples, <N_scatt> of examples/RUNLOG.md:21 (2000 photons,
# peel-off on), and the names of the slice's branches in res
CIV = 'healpix_CIV/CIV_test.in'
SL_CAR = 'sightline_tau/sightline_car.in'
SL_INSIDE = 'sightline_tau/sightline_inside.in'
CIV_NSCATT, CIV_NSIDE = 14.54, 64
INSIDE, EXPCYL = ' (interior)', ' (exponential_cylinder)'
# the volume and table sources: the Hubble grid the analytic geometries are
# held on (xyz_symmetry), and phase 5's three windows
VEL_EFFECT = 'vel_effect/t4NHI2_20_V0200.in'
# the per-cell temperature and the 3-D grid files: the names of the
# per-cell (Cartesian) and per-leaf (AMR) instances in res, the seed of the
# 1e3-1e5 K temperature cubes, the main path's kernels, lart_tpu's
# <N_scatt> of AlII_ex.in as written on the CPU with its photons
# (tools/temperature_cpu_runs.py AlII 100000 3), and phase 4's cuts
TEMP, LEAF_T = ' (per-cell T)', ' (per-leaf T)'
T_CUBE_SEED = 12
TEMP_PATH = ('refill_alias', 'fly_cartesian', 'scatter_lya', 'peel',
             'sightline')
ALII_CPU = (1.2130, 100000)
FEII_PHOTONS, MGII_A_PHOTONS = 100000, 20000
JELLY_T_TAU, JELLY_T_PHOTONS = 1e3, 4000
# a dense population whose rays cross more chords than K9's list holds
MANY_CHORDS = dict(clump_allow_overlap=True, clump_N_clumps=1000,
                   clump_radius=0.2, clump_tau0=0.3)


def log(phase, msg):
    print(f'[phase {phase}] {msg}', flush=True)


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, reps, before=None):
    """Mean ms of fn() over reps calls, CUDA events around each call (the
    host's launch time included); before() runs untimed ahead of each."""
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def turns(kernel, plain, reps, before=None, plain_reps=None):
    """(kernel ms, plain ms) measured in turns plain, kernel, kernel, plain."""
    pr = plain_reps or reps
    p1 = cuda_time(plain, pr, before)
    k1 = cuda_time(kernel, reps, before)
    k2 = cuda_time(kernel, reps, before)
    p2 = cuda_time(plain, pr, before)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for the work, the larger of its bytes over the memory rate and its f32
    operations over the peak rate."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def kernel_work(name, pre, ch, meta, stats=None):
    """(bytes, flops) that kernel `name` needs on the state `pre`, counted
    from its source: every lane's phase read once, the fields of the lanes
    it works on read and written once, each grid cell it gathers read once
    (a sightline's crossings for the peel, stats from the plain version on
    the same inputs; at least the lane's own cell for a flight, whose
    crossings are not reported), its tallies written once and, for the
    peel, each cube bin it deposits into written once.  The flops are
    counted per lane (refill, scatter) or per pair and crossing (peel); the
    flights' are left out, so their bound is their bytes, but for H2's
    two Voigt functions a step of K5 (stats from its plain version).  With
    the all-photons table the lanes' rows and counts (allph_work) are
    added."""
    nbytes, flops = _kernel_work(name, pre, ch, meta, stats)
    if ch.allph is not None:
        b, f = allph_work(name, pre, ch, stats)
        nbytes, flops = nbytes + b, flops + f
    return nbytes, flops


def allph_work(name, pre, ch, stats):
    """(bytes, flops) the all-photons table adds to kernel `name` on the
    state `pre`: K2 stores each launched lane's id and two counts and its
    birth row (rp0, xfreq1), ~25 flops of impact parameter; K4 reads and
    writes each scattering lane's two counts; a death (stats['deaths'],
    counted by the plain version on the same inputs) reads the lane's id
    and counts and writes rp, xfreq2 and the two counts (with Stokes also
    reads the triad and Q, U, V and writes I, Q, U, V), ~25 flops (~45
    with Stokes)."""
    from lart_tpu_torch.transport.state import AT_SCATTER, DEAD
    stokes = ch.allph.I is not None
    per_death = 12 + 16 + (36 + 16 if stokes else 0)
    deaths = (stats or {}).get('deaths', 0)
    if name.startswith('refill_'):
        k = int((pre.phase == DEAD).sum())
        return k * (12 + 8), k * 25
    if name == 'scatter_lya':
        k = int((pre.phase == AT_SCATTER).sum())
        return k * 16 + deaths * per_death, deaths * (45 if stokes else 25)
    return deaths * per_death, deaths * (45 if stokes else 25)


def _kernel_work(name, pre, ch, meta, stats=None):
    from lart_tpu_torch.transport.state import AT_SCATTER, DEAD, FFS, FLYING
    B, ph = pre.batch, pre.phase
    peel = ch.peel
    flag = B * 4 if peel is not None else 0      # the record's flag, written
    cells = meta.nx * meta.ny * meta.nz
    if name == 'voigt_h':
        # H(x, a) of every lane's xfreq: 4 bytes in and out, ~40 flops
        return B * 8, B * 40
    if name.startswith('refill_'):
        from lart_tpu_torch.transport.refill import GEOM_POINT
        k = int((ph == DEAD).sum())
        # on the AMR grid the source's node, read once: a fine-map voxel or
        # the descent's levels, its leaf's physics
        amr = 0 if ch.refill_params.amr is None \
            else (ch.refill_params.amr.levelmax + 1) * 20 + 32
        # on a clump medium the source's clump, read once: every clump's
        # centre and radius^2 (dense) or the CSR row and its candidates'
        # (and the clump's velocity); a containment test of ~9 flops each
        # (3 differences, a dot product of 5, a compare)
        cl = ch.refill_params.clump
        clump = flops = 0
        if cl is not None:
            m = cl.n if cl.dense else cl.K
            clump = m * 16 + (0 if cl.dense else cl.K * 4) + 12 * cl.moving
            flops = m * 9
        # an extended source: its instance's draws for each launched lane
        # (a Philox block and its trig, ~60 flops; its Cartesian cell, ~10;
        # moving, the cell's velocity, 12 B) and the tables it reads once:
        # the radial table's knots (each lane's ~11-step binary search, the
        # interpolation, exp and log, ~50 flops), or each distinct alias bin
        # a lane drew (its probability and alias, its star's position, its
        # leaf's centre and half-size or its profile knots, its weight;
        # a second Philox block, ~60 flops)
        src = ch.refill_params.source
        if src is not None:
            from lart_tpu_torch.transport.refill import (GEOM_LEAVES,
                                                         GEOM_PROFILE,
                                                         GEOM_STARS)
            clump += k * 12 if ch.refill_params.vel else 0
            flops += 70
            t = src.tabs
            if src.table is not None:
                clump += src.table.n * 8
                flops += 11 * 4
            elif t is not None and t.prob is not None:
                entry = {GEOM_STARS: 12, GEOM_LEAVES: 16,
                         GEOM_PROFILE: 16}.get(src.geom, 0) \
                    + (4 if t.wgt is not None else 0) \
                    * (2 if src.geom == GEOM_PROFILE else 1)
                clump += min(k, t.nbin) * (8 + entry)
                flops += 60 + (30 if src.geom == GEOM_PROFILE else 10)
        # a Cartesian grid at non-uniform temperature: each birth cell's a
        # and D (the point source's one cell)
        if ch.refill_params.cell_D is not None:
            clump += 8 * (min(k, cells) if src is not None
                          and src.geom != GEOM_POINT else 1)
        extra_flops = 0
        if src is not None and src.illum is not None:
            # an illumination: each round a lane drew (its Philox block,
            # ~60 flops, the sampler's geometry, ~140 for the star with its
            # 4 trig and 3 square roots and divisions, ~70 for the point),
            # the rounds counted by the plain version on these inputs; the
            # flux factor and rejected draws written once; with the stellar
            # peel the limb sample (up to 4 Philox blocks and 8 tests, ~300
            # flops) and its two record fields
            from lart_tpu_torch import testing
            from lart_tpu_torch.transport import refill as trefill
            tl = ch.zero_tallies(pre.device)
            if src.illum.kind != 'plane':
                trefill.refill_plain(testing.clone_state(pre), tl,
                                     ch.refill_params, 1, 0, 10 ** 9)
                rounds = k + float(tl.nrejected)
                per = 200 if src.illum.kind == 'stellar' else 130
                extra_flops += rounds * per
                clump += 8
            if src.illum.kind == 'stellar' and peel is not None:
                extra_flops += k * 300
                clump += k * 8
        lp = ch.refill_params.lp
        if lp is not None:
            # the profile's table: each distinct bin drawn, its probability,
            # alias and two edges; a Philox block and the alias, ~70 flops
            clump += min(k, lp.n) * 16
            extra_flops += k * 70
        return B * 4 + flag + k * 33 * 4 + ch.nxfreq * 4 + amr + clump, \
            k * (60 + flops) + extra_flops
    if name == 'scatter_lya':
        k = int((ph == AT_SCATTER).sum())
        sp = ch.scatter_params
        st = 9 if sp.stokes else 0
        grid = min(cells, k) * 4 if sp.rhokap is not None else 0
        # the record: k, xatom, u (and the triad, Q, U, V with Stokes; the
        # phase weights E1, E2, E3 of line types 2, 4, 5, 6)
        lane_E = 3 if sp.line.per_lane_E else 0
        rec = (7 + st + lane_E) * 4 if peel is not None else 0
        per_lane = (10 + st + 7 + st) * 4 + rec
        flops = sp.rounds * (60 + (40 if sp.stokes else 0)) + 120 + 60 * (st > 0)
        if sp.line.line_type != 1:
            # a redistribution's Philox block and its upper level's choice,
            # a Voigt function of each component (~40 flops each)
            flops += 40 + 40 * max(sp.line.nup, 2)
        if sp.dust:
            # each lane's event split: its cell's rhokapD (and velocity for
            # Jabs in a moving medium), a Voigt and a Philox block; the
            # Mueller table once; Jabs (and line type 8's Jabs_Ha) written
            # once
            grid += min(cells, k) * 4 * (1 + (3 if sp.vel else 0))
            grid += (7 * sp.mueller.n * 4 if sp.mueller else 0) \
                + ch.nxfreq * 4 * (2 if sp.lyb else 1)
            flops += 80
        if sp.h2 is not None:
            # the H2 split's two Voigt functions and Philox block, and an
            # H2 event's line choice (two more) and its u_par rounds
            flops += 4 * 40 + 40 + sp.rounds * 60
        if sp.lyb:
            # the band read, the conversion's frequency
            per_lane += 4
            flops += 10
        if sp.amr is not None:
            # each lane's node: its leaf id (and, local core-skip, its
            # centre and half-width), and at non-uniform temperature the
            # leaf's a and D
            from lart_tpu_torch.transport.scatter import CORE_SKIP_LOCAL
            grid += min(cells, k) * 4 * (
                1 + (4 if sp.core_skip == CORE_SKIP_LOCAL else 0)
                + (0 if sp.amr.uniform_temperature else 2))
        if sp.cell_D is not None:
            # a Cartesian grid at non-uniform temperature: each lane's cell's
            # a and D
            grid += min(cells, k) * 8
        if sp.clump is not None:
            # each lane's clump: its rhokap (rhokapD, velocity); the owner
            # draw (overlap mode) reads every clump's centre, radius^2 and
            # opacity once (dense) or each distinct CSR row and candidate,
            # and needs one pass of ~13 flops over them (the containment
            # test's 9, the masked opacity, the running sum, the compare;
            # the kernel's second pass is not counted); the frame shift
            # ~10 flops
            cl = sp.clump
            grid += min(cl.n, k) * 4 * (1 + cl.has_dust + 3 * cl.moving)
            flops += 10
            if cl.overlap:
                m = cl.n if cl.dense else cl.K
                grid += min(cl.n, m if cl.dense else k * m) * 20 \
                    + (0 if cl.dense else min(cl.cg_n ** 3, k) * cl.K * 4)
                flops += m * 13
        if sp.jpa is not None:
            # Pa written once (f64); rhokap_phys and the bin, ~10 flops
            grid += ch.jpa[1] * 8
            flops += 10
        return B * 4 + flag + k * per_lane + grid, k * flops
    if name == 'peel':
        # the flag of every lane; the position of each flagged lane; the
        # cell and weight of each lane with a pair in an image ('seen'),
        # with xfreq (and, lab_source, k) in mode direct or the record's
        # k, xatom, u (and the triad, Q, U, V with Stokes) in mode
        # resonance; each distinct grid cell read (rhokap, and the
        # velocity in a moving medium); each distinct bin of the cubes the
        # mode writes (direct: direc, and I with Stokes; resonance: scatt,
        # and I, Q, U, V with Stokes); the observers
        # (mode dust: the record's k, triad, Q, U, V and the lane's xfreq,
        # and the Mueller table with Stokes)
        from lart_tpu_torch.instruments.peel import DIRECT, STELLAR
        # (a conversion: the record's k and u, line type 8; a dust event
        # there also the lane's band)
        g = peel.grid
        if stats['mode'] == STELLAR:
            # the stellar peel: each newborn's xfreq, cell and limb sample
            # (and k in a moving medium); each distinct cell the crossing
            # pairs walk (rhokap, the mask byte, the velocity, a and D);
            # each distinct bin of Direct (Direct0, I) written once; a
            # pair's disk point, pixel and sphere test (~200 flops) and a
            # Voigt and ~20 flops a crossing
            per_lane = 4 * (6 + (3 if g.moving else 0))
            grid = stats['cells'] * (4 * ((4 if g.moving else 1)
                                          + (2 if g.cell_D is not None
                                             else 0))
                                     + (1 if g.mask is not None else 0))
            if g.amr is not None:
                grid += stats['nodes'] * (44 + (4 if g.amr.nf else 32))
            if g.clump is not None:
                grid += stats['csr'] * g.clump.K * 4 + stats['cells'] * 16
            ncubes = 1 + peel.direc0 + peel.stokes
            return (B * 4 + stats['lanes'] * per_lane + grid
                    + stats['bins'] * 4 * ncubes + peel.nobs * 12 * 4,
                    stats.get('crossings', 0) * 60 + stats['seen'] * 200)
        st = 9 if peel.stokes else 0
        dust = stats.get('seen_dust', 0)
        conv = stats.get('seen_conv', 0)
        if stats['mode'] == DIRECT:
            per_seen = 4 * (4 + 1 + (3 if peel.lab_source else 0))
            seen = stats['seen'] * per_seen
            ncubes = 2 if peel.stokes else 1
        else:
            # a resonance reads the record's E1, E2, E3 for line types 2, 4-6
            lane_E = 3 if g.line.per_lane_E else 0
            seen = ((stats['seen'] - dust - conv) * 4 * (4 + 7 + st + lane_E)
                    + dust * 4 * (4 + 4 + st + (1 if peel.lyb else 0))
                    + conv * 4 * (4 + 6))
            ncubes = 5 if peel.stokes else 1
        table = 7 * peel.mueller.n * 4 if dust and peel.mueller else 0
        grid = stats['cells'] * 4 * ((4 if g.moving else 1)
                                     + (1 if g.rhokapD is not None else 0)
                                     + (2 if g.amr is None
                                        and g.cell_D is not None else 0))
        if g.amr is not None:
            # the AMR walk: each distinct node's centre, half-width, leaf id
            # and neighbor row, and one fine-map voxel or its children; each
            # leaf's a and D at non-uniform temperature
            grid += stats['nodes'] * (44 + (4 if g.amr.nf else 32)) \
                + stats['cells'] * (0 if g.amr.uniform_temperature else 8)
        # with H2, two more Voigt functions a crossing
        per_crossing = 60 + (80 if g.h2 is not None else 0)
        if g.clump is not None:
            # the clump sightline: each distinct CSR cell's row of K
            # candidates, each distinct candidate's centre, radius^2 and
            # opacity (the stats' cells are the clumps); a crossing tests K
            # chords (~17 flops each: 3 differences, two dot products of 5,
            # the radius, the discriminant's fma, a compare; the clipping
            # and the profile of a crossed one are not counted)
            grid += stats['csr'] * g.clump.K * 4 + stats['cells'] * 16
            per_crossing = 40 + 17 * g.clump.K
        return (B * 4 + stats['lanes'] * 12 + seen + table
                + grid + stats['bins'] * 4 * ncubes + peel.nobs * 12 * 4,
                stats.get('crossings', 0) * per_crossing
                + stats['pairs'] * 150)
    k = int(((ph == FLYING) | (ph == FFS)).sum())
    grid = flops = 0
    spectra = ch.nxfreq * 4 * (1 + ch.nmu)
    if name == 'fly_amr':
        # each distinct node the lanes stood in, read once: its centre and
        # half-width, leaf id and neighbor row (44 B), with the octant
        # descent its children (32 B), else one fine-map voxel (4 B), and
        # its leaf's physics (rhokap, rhokapD, the velocity, a and D: 4-32
        # B); the lane state read and written once; a Voigt function (~40
        # flops, two more with H2) and ~40 flops of faces and hops a step
        f = ch.flight
        a = f.amr
        nodes = int(stats['nodes'].sum())
        leaf = 4 * (1 + (f.rhokapD is not None) + 3 * f.moving
                    + 2 * (not a.uniform_temperature))
        per_node = 44 + (4 if a.nf else 32) + leaf
        flops = stats['steps'] * (80 + (80 if f.h2 is not None else 0))
        if f.lyb:
            grid += k * 4
            spectra += ch.nxfreq * 4
        return B * 4 + k * (24 + 12) * 4 + nodes * per_node + grid + spectra, \
            flops
    if name == 'fly_clump_dense':
        # the lane state read and written once; every clump's centre,
        # radius^2, opacity (rhokapD, velocity) read once; ~17 flops a clump
        # a lane-step (the chord test against all N: 3 differences, two dot
        # products of 5, the radius, the discriminant's fma, a compare), a
        # profile a step (one a crossed chord in a moving medium), and on a
        # crossed chord its clipping and weight (~10 flops) and 13
        # evaluations of F (~6 flops each)
        cl = ch.flight.clump
        per_clump = 4 * (5 + cl.has_dust + 3 * cl.moving)
        flops = stats['steps'] * (17 * cl.n + 40) + stats['chords'] * (
            10 + 13 * 6 + (40 if cl.moving else 0))
        return B * 4 + k * (24 + 12) * 4 + cl.n * per_clump + spectra, flops
    if name == 'fly_clump_csr':
        # the lane state read and written once; each distinct CSR cell's
        # row of K candidates and each distinct candidate's centre,
        # radius^2, opacity (rhokapD, velocity) read once; ~17 flops a
        # candidate a lane-step (its chord test; the profile of a crossed
        # one in overlap mode is not counted)
        from lart_tpu_torch.transport.fly_clump import csr_work
        cl = ch.flight.clump
        w = csr_work(stats, cl)
        per_clump = 4 * (5 + cl.has_dust + 3 * cl.moving)
        return (B * 4 + k * (24 + 12) * 4 + w['cells'] * cl.K * 4
                + w['clumps'] * per_clump + spectra,
                stats['steps'] * (17 * cl.K + 40))
    if name == 'fly_cartesian':
        f = ch.flight
        # rhokap (rhokapD, the velocity; at non-uniform temperature a and
        # D) of each distinct cell, at least the lanes' own; in an
        # atmosphere the mask byte and Jabs2 written once
        grid = min(cells, k) * 4 * ((4 if f.moving else 1)
                                    + (1 if f.rhokapD is not None else 0)
                                    + (2 if f.cell_D is not None else 0))
        if f.atmosphere:
            grid += min(cells, k) * (1 if f.mask is not None else 0)
            spectra += ch.nxfreq * 4
        if f.lyb:
            # each lane's band; Jout_Ha written once
            grid += k * 4
            spectra += ch.nxfreq * 4
        if f.h2 is not None and stats:
            # the H2 opacity's two Voigt functions each step
            flops = stats['steps'] * 80
        if f.omega_shear:
            # each lane's vfy_shear, read and written
            grid += k * 8
        if f.jpa is not None:
            # J1 and Pnew written once (f64)
            spectra += 8 * sum(ch.jpa[0::2])
    return B * 4 + k * (24 + 12) * 4 + grid + spectra, flops


def sightline_work(sl, stats):
    """(bytes, flops) of K11's maps: the maps written once (4 B a ray),
    the observers and the column frequencies read once, each distinct cell
    read once (rhokap; rhokapD with dust; the velocity in a moving medium;
    a clump's centre, radius^2 and opacities), ~20 flops a column crossing
    (N_gas, tau_dust) and, a tau_gas crossing, 20 and ~40 a Voigt component
    of the line's profile (two for a doublet), plus ~60 a ray to build it
    (the TAN inverse or the HEALPix centre, the box clip); at non-uniform
    temperature each cell's a and D (8 B) too."""
    g = sl.grid
    per_cell = 4 * (1 + (g.rhokapD is not None) + 3 * g.moving
                    + 2 * (g.amr is None and g.cell_D is not None))
    if g.clump is not None:
        per_cell = 4 * (5 + g.clump.has_dust + 3 * g.clump.moving)
    ncomp = {1: 1, 2: 2, 7: 2}.get(g.line.line_type, g.line.nup)
    nbytes = (sl.nobs * sl.ncol * sl.npix * 4 + sl.nobs * 48
              + sl.grid.nxfreq * 4 + stats['cells'] * per_cell)
    flops = (stats['col'] * 20 + stats['gas'] * (20 + 40 * ncomp)
             + stats['rays'] * 60)
    return nbytes, flops


def example_params(rel, **over):
    """examples/<rel> as Params, with the keys of `over` replaced."""
    from lart_tpu_torch.config import Params
    par = Params.from_namelist(str(ROOT / 'examples' / rel))
    for k, v in over.items():
        setattr(par, k, v)
    return par


def namelist_variant(rel, out_dir, text=None, **over):
    """examples/<rel> (or the namelist `text`, written as its name)
    rewritten into out_dir with `over` set (one par%key = value per line)
    and FITS output."""
    text = text if text is not None else (ROOT / 'examples' / rel).read_text()
    text = re.sub(r"(?m)^\s*par%out_file\s*=.*\n", '', text)
    over = dict(over, file_format="'fits'")
    for k, v in over.items():
        line = f' par%{k} = {v}'
        text, n = re.subn(rf'(?m)^\s*par%{k}\s*=.*$', line, text)
        if not n:
            text = text.rstrip()
            assert text.endswith('/'), 'namelist must end with /'
            text = text[:-1].rstrip() + f'\n{line}\n/\n'
    path = Path(out_dir) / Path(rel).name
    path.write_text(text)
    return path


def phase0():
    from lart_tpu_torch.kernels.build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), '--version'], capture_output=True,
                          text=True, check=True).stdout
    m = re.search(r'release ([0-9.]+)', nvcc)
    log(0, f'{smi()} | torch {torch.__version__} cuda {torch.version.cuda} '
           f'nvcc {m.group(1) if m else "?"} | {torch.cuda.get_device_name(0)}'
           f' x{torch.cuda.device_count()}')


def phase1():
    from lart_tpu_torch.kernels import build as kb
    t0 = time.time()
    kb.library()
    regs = re.findall(r"Compiling entry function '_Z(\d+)(\w+)'|(\d+) bytes "
                      r"spill stores|Used (\d+) registers",
                      kb.BUILD_INFO.get('ptxas', ''))
    per, spills = {}, {}
    name = None
    for n, fn, spill, used in regs:
        if spill:
            if name and int(spill):
                spills[name] = int(spill)
            continue
        if fn:
            # a kernel's instances (line.cuh kMulti, h2.cuh kH2, refill.cu
            # kSrc) by their template arguments
            m = re.match(r'I((?:L[bi]\d+E)+)', fn[int(n):])
            name = fn[:int(n)] + ('<' + ', '.join(
                ('true' if v == '1' else 'false') if t == 'b' else v
                for t, v in re.findall(r'L([bi])(\d+)E', m.group(1))) + '>'
                if m else '')
        elif name:
            per[name] = int(used)
    secs = {k: round(v, 1) for k, v in
            kb.BUILD_INFO.get('source_seconds', {}).items()}
    log(1, f'built {Path(kb.BUILD_INFO["path"]).name} from '
           f'{len(kb.SOURCES)} sources in {kb.BUILD_INFO["seconds"]:.1f} s '
           f'(load {time.time() - t0:.1f} s; each source\'s nvcc, s: {secs});'
           f' ptxas registers: {per}; spill stores (bytes): {spills or 0}')


def both(meta, state_seed, step, check_tallies, dev, r_max=None, nmu=8,
         state=None, lyb=False, h2=False, tallies=None, out=None):
    """step(state, tallies, kernel) through the kernel and through the
    plain version from one mixed state (or `state`), with line type 8's
    (lyb) and H2's tallies where asked (or tallies(dev)'s); returns (s0,
    kernel state, fraction of lanes differing, max abs error of the
    others, tallies' max |d|); `out`, a dict, receives both tallies under
    True (the kernel's) and False."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.state import zero_tallies
    s0 = state if state is not None else testing.mixed_state(
        meta, B_MAIN, state_seed, dev, r_max=r_max)
    sk, sp = testing.clone_state(s0), testing.clone_state(s0)
    if tallies is None:
        def tallies(d):
            return zero_tallies(meta.nxfreq, nmu, d, lyb, h2)
    tk, tp = tallies(dev), tallies(dev)
    step(sk, tk, True)
    step(sp, tp, False)
    torch.cuda.synchronize()
    if out is not None:
        out.update({True: tk, False: tp})
    frac, err = testing.compare_states(sk, sp, LANE_RTOL, LANE_ATOL)
    tal = {}
    for f in check_tallies:
        u, v = getattr(tk, f), getattr(tp, f)
        if u.numel() == 0:      # Jmu without save_Jmu
            continue
        atol = 1e-5 * max(float(v.abs().sum()), 1.0)
        d = float((u - v).abs().max())
        assert d <= atol, (f, d, atol)
        tal[f] = d
    assert frac <= MAX_FRAC, (frac, state_diff_report(s0, sk, sp))
    return s0, sk, frac, err, tal


def state_diff_report(s0, a, b, n=4):
    """The fields in which states a and b differ, with the count of lanes
    and, for the first n, the lane's input xfreq and both values."""
    from lart_tpu_torch.transport.state import INT_FIELDS, LANE_FIELDS
    out = []
    for f in LANE_FIELDS:
        u, v = getattr(a, f), getattr(b, f)
        bad = (u != v) if f in INT_FIELDS else ~torch.isclose(
            u, v, rtol=LANE_RTOL, atol=LANE_ATOL, equal_nan=True)
        idx = bad.nonzero().squeeze(1)[:n].tolist()
        if idx:
            out.append(f'{f}: {int(bad.sum())} lanes, e.g. ' + ', '.join(
                f'lane {i} x0 {float(s0.xfreq[i]):.6g} {float(u[i]):.9g} vs '
                f'{float(v[i]):.9g}' for i in idx))
    return '; '.join(out)


def _max_err(res, name, err):
    res.setdefault(name, {'max_abs_err': 0.0})
    res[name]['max_abs_err'] = max(res[name]['max_abs_err'], err)


def fly_step(chunk):
    """step() of both(): the chunk's flight, kernel or plain version."""
    def step(s, t, kernel):
        mod = sys.modules[type(chunk.flight).__module__]
        (mod.fly if kernel else mod.fly_plain)(
            s, t, chunk.flight, chunk.fly_substeps)
    return step


def refill_step(chunk):
    from lart_tpu_torch.transport import refill

    def step(s, t, kernel):
        (refill.refill if kernel else refill.refill_plain)(
            s, t, chunk.refill_params, 7, 12345, 10 ** 9)
    return step


def scatter_step(chunk, params=None, recs=None):
    """step() of both(): K4 or its plain version with `params` (the
    chunk's by default); with `recs`, a dict, each writes a peel record
    that lands in recs[kernel]."""
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport import scatter
    sp = params or chunk.scatter_params

    def step(s, t, kernel):
        rec = None
        if recs is not None:
            rec = recs[kernel] = tpeel.PeelRecord.zeros(s.batch, s.device)
        (scatter.scatter if kernel else scatter.scatter_plain)(
            s, t, sp, 7, 99, rec)
    return step


def phase2(dev):
    """Kernel vs plain version on the card, lane by lane."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.physics.voigt import voigt, voigt_plain
    from lart_tpu_torch.transport import fly_slab, refill, scatter
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.state import DEAD, zero_tallies
    res = {}

    # K1 over all four Humlicek regions
    rng = np.random.default_rng(11)
    n = 1 << 20
    x = np.concatenate([rng.uniform(-3e3, 3e3, n // 4),
                        rng.uniform(-20.0, 20.0, n // 4),
                        rng.uniform(-6.0, 6.0, n // 4),
                        np.sign(rng.uniform(-1, 1, n // 4))
                        * np.exp(rng.uniform(-7.0, 8.0, n // 4))])
    a = np.exp(rng.uniform(np.log(1e-6), np.log(0.1), n))
    s = np.abs(x) + a
    region = np.where(s >= 15, 1, np.where(s >= 5.5, 2, np.where(
        a >= 0.195 * np.abs(x) - 0.176, 3, 4)))
    counts = np.bincount(region, minlength=5)[1:]
    assert (counts > 1000).all(), counts
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    hk, hp = voigt(xt, at), voigt_plain(xt, at)
    torch.cuda.synchronize()
    rel = ((hk - hp).abs() / hp.abs()).max().item()
    assert torch.isfinite(hk).all() and rel <= 2e-5, rel
    res['voigt_h'] = {'max_abs_err': (hk - hp).abs().max().item()}
    log(2, f'K1 voigt_h: {n} points, regions I-IV {counts.tolist()}, max rel '
           f'err {rel:.3e} (rtol 2e-5)')

    # flagship slab at the main path's batch
    par = testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                              batch=B_MAIN, chunk_cycles=32)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    nx = meta.nxfreq

    _, _, frac, err, tal = both(meta, 21, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev)
    _max_err(res, 'fly_uniform_slab', err)
    log(2, f'K3 fly_uniform_slab: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e} (rtol {LANE_RTOL}, atol {LANE_ATOL}, max {MAX_FRAC}),'
           f' max abs err {err:.3e}; tallies max |d| {tal} (atol 1e-5 x sum)')

    s0, sk, frac, err, tal = both(meta, 22, refill_step(ch), ('Jin',), dev)
    n_dead = int((s0.phase == DEAD).sum())
    assert int(sk.n_launched[0]) == n_dead
    _max_err(res, 'refill_point', err)
    # budget-limited: exactly min(#dead, remaining) launch
    for kernel in (True, False):
        st = testing.clone_state(s0)
        rem = n_dead // 3
        (refill.refill if kernel else refill.refill_plain)(
            st, zero_tallies(nx, 8, dev), ch.refill_params, 7, 12345, rem)
        n_l = int((st.phase != s0.phase).sum())
        assert int(st.n_launched[0]) == rem and n_l == rem, (kernel, n_l, rem)
    log(2, f'K2 refill_point: {n_dead} dead lanes all launched, lanes '
           f'differing {frac:.2e}, max abs err {err:.3e}, Jin max |d| '
           f'{tal["Jin"]:.3e}; budget-limited launch count exact')

    _, _, frac, err, tal = both(meta, 23, scatter_step(ch),
                                ('nscatt_gas', 'nscatt_events'), dev)
    _max_err(res, 'scatter_lya', err)
    log(2, f'K4 scatter_lya: B={B_MAIN} mixed phases, lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}; nscatt max |d| {tal}')

    # K5 on the slab with force_generic_kernel: periodic x/y
    par = testing.slab_params(tau0=1e6, nz=201, batch=B_MAIN,
                              force_generic_kernel=True)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    _, _, frac, err, tal = both(meta, 24, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev, nmu=ch.nmu)
    _max_err(res, 'fly_cartesian', err)
    log(2, f'K5 fly_cartesian, slab 1x1x201 periodic (force_generic_kernel):'
           f' lanes differing {frac:.2e}, max abs err {err:.3e}; tallies '
           f'max |d| {tal}')

    # K5 and K2 on the full vel_effect grid: 201^3, reflect, Hubble flow;
    # the source moved off the centre cell, whose velocity is 0
    t0 = time.time()
    par = example_params('vel_effect/t4NHI2_20_V0200.in', batch_size=B_MAIN,
                         xs_point=0.31, ys_point=0.17, zs_point=0.05)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    t_grid = time.time() - t0
    _, _, frac, err, tal = both(meta, 25, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor'), dev, nmu=ch.nmu)
    _max_err(res, 'fly_cartesian', err)
    log(2, f'K5 fly_cartesian, vel_effect V0200 201^3 reflect + Hubble flow '
           f'(grid built in {t_grid:.1f} s): lanes differing {frac:.2e}, '
           f'max abs err {err:.3e}; tallies max |d| {tal}')
    v = ch.refill_params.v_src
    assert any(c != 0.0 for c in v), v
    s0, sk, frac, err, tal = both(meta, 26, refill_step(ch), ('Jin',), dev)
    _max_err(res, 'refill_point', err)
    log(2, f'K2 refill_point, moving medium (comoving_source false, source '
           f'cell velocity {tuple(round(c, 4) for c in v)}): lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}, Jin max |d| {tal["Jin"]:.3e}')
    # K4 local core-skip with the rhokap gather (DDA path)
    cfg = example_params('vel_effect/t4NHI2_20_V0200.in', batch_size=B_MAIN,
                         core_skip=True).resolve()
    ch = make_chunk(cfg, meta, grid)
    assert ch.scatter_params.rhokap is not None
    _, _, frac, err, tal = both(meta, 27, scatter_step(ch),
                                ('nscatt_gas', 'nscatt_events'), dev,
                                r_max=1.0)
    _max_err(res, 'scatter_lya', err)
    log(2, f'K4 scatter_lya, local core-skip with the rhokap gather '
           f'(vel_effect grid): lanes differing {frac:.2e}, max abs err '
           f'{err:.3e}')
    del grid, ch

    # K6 and K4 core-skip on the t4tau7 sphere
    for glob in (False, True):
        par = example_params('sphere/t4tau7.in', batch_size=B_MAIN,
                             core_skip_global=glob)
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        if not glob:
            _, _, frac, err, tal = both(meta, 28, fly_step(ch),
                                        ('Jout', 'Jmu', 'W_oor'), dev,
                                        nmu=ch.nmu)
            _max_err(res, 'fly_uniform_sphere', err)
            log(2, f'K6 fly_uniform_sphere, t4tau7 129^3 tau 1e7: lanes '
                   f'differing {frac:.2e}, max abs err {err:.3e}; tallies '
                   f'max |d| {tal}')
        s0, sk, frac, err, tal = both(meta, 29, scatter_step(ch),
                                      ('nscatt_gas', 'nscatt_events'), dev,
                                      r_max=1.0)
        _max_err(res, 'scatter_lya', err)
        p = ch.scatter_params
        boosted = _in_core_fraction(s0, p)
        log(2, f'K4 scatter_lya, {"global" if glob else "local"} core-skip '
               f'on t4tau7 (xcrit {p.xcrit:.4f} global, rk_const '
               f'{p.rk_const:.4e}): {boosted:.3f} of the lanes in the core, '
               f'lanes differing {frac:.2e}, max abs err {err:.3e}')
    del grid, ch
    phase2_peel(dev, res)
    phase2_peel_hot(dev, res)
    phase2_dust(dev, res)
    phase2_lines(dev, res)
    phase2_lyb_h2(dev, res)
    phase2_amr(dev, res)
    phase2_clump(dev, res)
    phase2_inside(dev, res)
    phase2_sources(dev, res)
    phase2_temperature(dev, res)
    phase2_atmosphere(dev, res)
    phase2_shear(dev, res)
    phase2_allph(dev, res)
    return res


def peel_both(ch, meta, seed, mode, dev, r_max=None, prep=None,
              state_fn=None, rec_prep=None, min_dep=0.05, info=None,
              share=None, batch=None):
    """K7 and its plain version on one mixed state with a record that
    flags every lane; each (observer, lane) pair's optical depth and cube
    bin are held against each other (a pair differs when its bin differs
    or its tau misses rtol/atol), then each other pair's deposits (the
    scatt or direc one, and Q, U, V of a Stokes resonance peel): the
    plain version's, times exp(tau_plain - tau_kernel) for the last bits
    of tau, to 1e-5 of the larger of the pair's scatt or direc deposit
    and its unpolarized one, exp(-tau) wgt / (4 pi r^2) (the dipole's
    I = S11 + S12 Q cancels toward 0, Q, U, V are bounded by I, and f32
    rounds each term to its own scale), + 1e-37 (f32 subnormals); every
    such pair must agree.  Then the cubes, without the lanes of differing
    pairs, to 1e-5 of their sum (atomics add in no fixed order).  Returns
    (pairs differing, pairs depositing, max abs error of the cubes, max
    |d tau| and max |d w| over that scale of the other pairs).  prep(s),
    where given, changes the state first (the H-alpha band's lanes);
    state_fn(seed), where given, makes the state (an AMR grid's);
    rec_prep(rec), where given, changes the record (a stellar source's
    limb samples); at least a share min_dep of the pairs must deposit.
    info, a dict where given, gains the plain version's depositing pairs
    whose deposits are all 0 ('zero'), its distinct bins ('bins') and the
    most pairs in one bin ('hottest').  With share, the record flags that
    share of the lanes, scattered among the others, and info gains the
    count of flagged lanes ('flagged') and, of K7's call, its launches
    ('launches'), the parity of its lane list ('parity') and the count
    its first pass listed there ('listed')."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.kernels import build as kb
    p = ch.peel
    B = batch or B_MAIN
    s = state_fn(seed) if state_fn is not None else testing.mixed_state(
        meta, B, seed, dev, r_max=r_max)
    if prep is not None:
        prep(s)
    rec = testing.peel_record(s, seed + 1, p.grid.line)
    if rec_prep is not None:
        rec_prep(rec)
    kind = max(mode, tpeel.RESONANCE)     # the flag of mode's events
    if share is None:
        rec.flag.fill_(kind)
    else:
        on = np.random.default_rng([seed, 7]).random(B) < share
        rec.flag.copy_(torch.as_tensor(on.astype(np.int32) * kind,
                                       device=dev))
        info['flagged'] = int(on.sum())
    n = p.nobs * B
    ncomp = 4 if p.stokes and mode not in (tpeel.DIRECT,
                                           tpeel.STELLAR) else 1

    def run(kernel):
        cubes = p.zero_cubes(dev)
        tau = torch.full((n,), -1.0, device=dev)
        bins = torch.full((n,), -1, dtype=torch.int32, device=dev)
        w = torch.zeros((4 * n,), device=dev)
        before = kb.LAUNCHES['peel']
        (tpeel.peel if kernel else tpeel.peel_plain)(s, cubes, rec, p, mode,
                                                     tau, bins, w)
        torch.cuda.synchronize()
        if kernel and share is not None:
            lanes = p.lane_list(s)
            used = 1 - lanes.parity
            info.update(launches=kb.LAUNCHES['peel'] - before,
                        parity=used, listed=int(lanes.order[B + used]))
        return cubes, tau, bins, w.view(4, n)[:ncomp].double()

    (ck, tk, bk, wk), (cp, tp, bp, wp) = run(True), run(False)
    bad = (bk != bp) | ~torch.isclose(tk, tp, rtol=LANE_RTOL, atol=LANE_ATOL)
    n_bad, n_dep = int(bad.sum()), int((bp >= 0).sum())
    if info is not None and n_dep:
        on = bp >= 0
        info.update(zero=int((on & (wp == 0).all(0)).sum()),
                    bins=int(torch.unique(bp[on]).numel()),
                    hottest=int(torch.bincount(bp[on].long()).max()))
    good = ~bad & (bp >= 0)
    dtau = float((tk - tp).abs()[good].max()) if bool(good.any()) else 0.0
    # the plain version's deposits at the kernel's tau
    shift = torch.exp(torch.clamp_max(tp.double(), 700.0)
                      - torch.clamp_max(tk.double(), 700.0))
    want = wp * shift
    pos = torch.stack([s.x, s.y, s.z], 1).double()
    r2 = ((p.pos.double()[:, None, :] - pos[None]) ** 2).sum(-1).reshape(n)
    unpol = torch.exp(-torch.clamp_max(tk.double(), 700.0)) \
        * s.wgt.double().repeat(p.nobs) / (4.0 * np.pi * r2)
    scale = torch.maximum(want[0].abs(), unpol)
    dw = (wk - want).abs().amax(0)
    w_bad = good & (dw > 1e-5 * scale + 1e-37)
    assert not bool(w_bad.any()), ('pair deposits differ', int(w_bad.sum()))
    dw_rel = float((dw / scale.clamp_min(1e-37))[good].max()) \
        if bool(good.any()) else 0.0
    if n_bad:
        rec.flag.copy_((~bad.view(p.nobs, B).any(0)).to(torch.int32)
                       * kind)
        ck, cp = run(True)[0], run(False)[0]
    err = 0.0
    for (name, u), (_, v) in zip(ck.items(), cp.items()):
        d = float((u - v).abs().max())
        tol = 1e-5 * max(float(v.abs().sum()), 1e-30)
        assert d <= tol, (name, d, tol)
        err = max(err, d)
    assert n_bad <= MAX_FRAC * n and n_dep >= min_dep * n, (n_bad, n_dep, n)
    return n_bad, n_dep, err, dtau, dw_rel


def record_diff(a, b, dust_xatom=False):
    """(lanes whose peel records differ, max abs error of the others): the
    flag exactly, the event fields of the flagged lanes to rtol/atol; a
    dust event's (flag 2) are its direction, triad and Stokes vector, and
    with dust_xatom (a clump medium) its frequency in xatom."""
    from lart_tpu_torch.instruments.peel import DUST, PEEL_RECORD_FIELDS
    bad = a.flag != b.flag
    err = 0.0
    for f in PEEL_RECORD_FIELDS[1:]:
        on = (a.flag != 0) if f not in ('xatom', 'ux', 'uy', 'uz', 'E1',
                                        'E2', 'E3') \
            or (f == 'xatom' and dust_xatom) \
            else (a.flag != 0) & (a.flag != DUST)
        u, v = getattr(a, f), getattr(b, f)
        off = on & ~torch.isclose(u, v, rtol=LANE_RTOL, atol=LANE_ATOL)
        bad |= off
        if bool((on & ~off).any()):
            err = max(err, float((u - v).abs()[on & ~off].max()))
    return int(bad.sum()), err


def phase2_peel(dev, res):
    """K7 on the grids of the three peel-off examples as written, and K4
    and K2 with their peel records on each."""
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.engine import make_chunk
    modes = (('direct', tpeel.DIRECT), ('resonance', tpeel.RESONANCE))
    seed = 40
    for name, over, r_max, what in (
            ('slab_peel', {}, None, 'periodic slab walk, Stokes'),
            ('sphere_peel', {}, 1.0, 'sphere chord, Stokes'),
            ('sphere_peel', {'use_stokes': False}, 1.0,
             'sphere chord, no Stokes'),
            ('vel_effect_peel', {}, 1.0,
             '201^3 walk, Hubble flow, no Stokes')):
        t0 = time.time()
        cfg = example_params(PEEL_EXAMPLES[name], batch_size=B_MAIN,
                             **over).resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        t_grid = time.time() - t0
        for label, mode in modes:
            seed += 2
            t1 = time.time()
            n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed, mode,
                                                    dev, r_max)
            _max_err(res, 'peel', err)
            log(2, f'K7 peel {label}, {name} ({what}; {ch.peel.nobs} '
                   f'observer, {ch.peel.obs_meta.nxim}x'
                   f'{ch.peel.obs_meta.nyim} x {meta.nxfreq} bins): '
                   f'{n_dep} of {ch.peel.nobs * B_MAIN} pairs deposit, '
                   f'pairs differing {n_bad} (max {MAX_FRAC} of them), '
                   f'max |d tau| {dtau:.3e}, per-pair deposits max rel '
                   f'err {dw:.3e} (rtol 1e-5, all pairs), cubes max abs '
                   f'err {err:.3e} (atol 1e-5 x sum; '
                   f'{time.time() - t1:.1f} s, grid {t_grid:.1f} s)')
        if name == 'slab_peel' and not over:
            seed += 2
            peel_packed('slab_peel, resonance, Stokes', ch, meta, seed,
                        tpeel.RESONANCE, dev, res)
        if not over:
            seed = k4_k2_with_record(name, ch, meta, dev, r_max, seed, res)
        del grid, ch


# K7's hot-bin cases (phase2_peel_hot): the slab_peel grid with dust
# (DGR 1e5: a dust optical depth of 1.75 through the slab) and two
# observers, and the lanes' frequency: in the wing at x = 8 (tau ~0.1 from
# the top cell) or at line centre in the centre cell (tau ~5e3: most
# deposits 0)
HOT_PEEL = dict(DGR=1e5, nobs=2, alpha=(0.0, 30.0), beta=(0.0, 60.0))
HOT_X, HOT = 8.0, ' (hot bins)'


def pinned_state(meta, seed, dev, cell, xfreq, k=None,
                 half=(0.075, 0.075, 1e-4)):
    """testing.hot_state's lanes in `cell` (the centre cell where None) at
    xfreq, moved to within half[axis] cell widths of the cell's centre
    (on the slab_peel grid's cell, 2 wide in x and y, a 0.3-wide square
    that each observer sees in ~100 pixels); with k, every lane's
    direction (x, y, z)."""
    from lart_tpu_torch import testing
    s = testing.hot_state(meta, B_MAIN, seed, dev, cell=cell, xfreq=xfreq)
    rng = np.random.default_rng([seed, 5])
    n = (meta.nx, meta.ny, meta.nz)
    c = tuple(v // 2 for v in n) if cell is None else cell
    for ax, f in enumerate('xyz'):
        lo = (meta.xmin, meta.ymin, meta.zmin)[ax]
        d = (meta.dx, meta.dy, meta.dz)[ax]
        getattr(s, f).copy_(torch.as_tensor(
            lo + (c[ax] + 0.5 + rng.uniform(-half[ax], half[ax], B_MAIN))
            * d,
            dtype=torch.float32, device=dev))
    if k is not None:
        for f, v in zip(('kx', 'ky', 'kz'), k):
            getattr(s, f).fill_(v)
    return s


def phase2_peel_hot(dev, res):
    """K7 where its deposits crowd into few bins: every lane at one point
    of the slab_peel grid (pinned_state), with Stokes and two observers, at
    one frequency (a hot state: the top cell, x = 8) in modes direct,
    resonance and dust, and a thick state (the centre cell at line centre:
    most pairs' deposits 0, their walks stop at tau 110); PEEL_STELLAR on
    a090 with its observer on +z, every newborn at one point, frequency
    and direction, the limb samples 64 points of the disk (64 bins).  A
    bin takes ~1e3 pairs: the plain version's f32 atomics, in lane order,
    round a bin of N equal values to ~N 2^-24 of it, so a cube of a few
    bins would miss the 1e-5 on the plain version's side.
    0 pairs may differ, and the cubes agree to 1e-5 of their sums
    (peel_both)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.engine import make_chunk
    cfg = example_params(PEEL_EXAMPLES['slab_peel'], batch_size=B_MAIN,
                         **HOT_PEEL).resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    assert ch.peel.stokes and ch.peel.nobs == 2 and ch.peel.dust
    top = (0, 0, meta.nz - 1)
    seed = 900
    for label, cell, x, mode in (
            ('direct, hot', top, HOT_X, tpeel.DIRECT),
            ('resonance, hot', top, HOT_X, tpeel.RESONANCE),
            ('dust, hot', top, HOT_X, tpeel.DUST),
            ('resonance, thick', None, 0.0, tpeel.RESONANCE)):
        seed += 10
        info = {}
        n_bad, n_dep, err, dtau, dw = peel_both(
            ch, meta, seed, mode, dev, info=info,
            state_fn=lambda sd, c=cell, x=x: pinned_state(meta, sd, dev, c,
                                                          x))
        assert n_bad == 0, (label, n_bad)
        if label.endswith('thick'):
            assert info['zero'] > 0.5 * n_dep, info
        _max_err(res, 'peel' + HOT, err)
        log(2, f'K7 peel {label} (slab_peel grid, Stokes, dust, 2 observers,'
               f' every lane at the centre of cell {cell or "centre"}, x '
               f'{x}): {n_dep} '
               f'of {ch.peel.nobs * B_MAIN} pairs deposit, {info["zero"]} of'
               f' them all 0, into {info["bins"]} bins (at most '
               f'{info["hottest"]} pairs a bin); pairs differing {n_bad}, max'
               f' |d tau| {dtau:.3e}, per-pair deposits max rel err {dw:.3e}'
               f', cubes max abs err {err:.3e} (atol 1e-5 x sum)')
    del ch, grid
    def limb_points(rec):
        # 64 points of the disk: cos theta and vphi on an 8 x 8 lattice
        i = torch.arange(B_MAIN, device=dev)
        rec.limb_cost.copy_(((i % 8).float() + 0.5) / 8.0)
        rec.limb_vphi.copy_(((i // 8 % 8).float() + 0.5) * (np.pi / 4.0))
    cfg = testing.source_params(
        'a090', ROOT, batch_size=B_MAIN, obsx=(0.0,), obsy=(0.0,),
        obsz=(1e5,), alpha=(0.0,), beta=(0.0,), nobs=1,
        save_direc0=True).resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    info = {}
    seed += 10
    n_bad, n_dep, err, dtau, dw = peel_both(
        ch, meta, seed, tpeel.STELLAR, dev, info=info,
        state_fn=lambda sd: pinned_state(meta, sd, dev, None, 0.0,
                                         (0.0, 0.0, 1.0)),
        rec_prep=limb_points)
    assert n_bad == 0, n_bad
    _max_err(res, 'peel' + STELLAR_K + HOT, err)
    log(2, f'K7 peel stellar, hot (a090 on +z, Direct0, every newborn at x '
           f'0 and k +z, 64 points of the disk): {n_dep} of {B_MAIN} pairs in the image and the band, into '
           f'{info.get("bins", 0)} bins (at most {info.get("hottest", 0)} '
           f'pairs a bin); pairs differing {n_bad}, max |d tau| {dtau:.3e}, '
           f'per-pair deposits max rel err {dw:.3e}, cubes max abs err '
           f'{err:.3e}')


# K7's packed walks (peel_packed): a quarter of the lanes flagged, so that
# under half are peeled and their pairs fill at least min_pack threads; the
# batch is PACK_B lanes whatever B_MAIN is (at 8192 no pairs pack)
PACK_SHARE, PACK_B, PACKED = 0.25, 131072, ' (packed)'


def peel_packed(label, ch, meta, seed, mode, dev, res, r_max=None):
    """K7 where it packs its pairs into full warps (csrc/peel.cu
    peel_kernel: thread j takes observer j / c and lane order[j % c] of its
    first pass's list of c lanes): a record flagging PACK_SHARE of PACK_B
    lanes, scattered among the others, against the plain version
    (peel_both: 0 pairs differing in tau, bin and deposits, the cubes to
    1e-5 of their sums), in two calls, so that both counts of the lane list
    take their turn.  Each call must make both launches, its first pass
    must list every flagged lane, and that count must pack (peel.packs, the
    kernel's own test)."""
    from lart_tpu_torch.instruments import peel as tpeel
    p = ch.peel
    p._lanes.clear()        # a new list runs its first pass and samples
    parities = []
    for call in range(2):
        info = {}
        n_bad, n_dep, err, dtau, dw = peel_both(
            ch, meta, seed + call, mode, dev, r_max, info=info,
            min_dep=0.05 * PACK_SHARE, share=PACK_SHARE, batch=PACK_B)
        assert n_bad == 0, (label, n_bad)
        assert info['launches'] == 2 and \
            info['listed'] == info['flagged'], (label, info)
        assert tpeel.packs(info['listed'], PACK_B, p.nobs,
                           tpeel.min_pack(dev)), (label, info)
        parities.append(info['parity'])
        _max_err(res, 'peel' + PACKED, err)
        res['peel' + PACKED].setdefault('cases', []).append(
            f'{label}: {info["listed"]} of {PACK_B} lanes, parity '
            f'{info["parity"]}, {n_dep} pairs deposit, 0 differing')
        log(2, f'K7 peel packed, {label} (call {call + 1}): the first pass '
               f'listed {info["listed"]} of {PACK_B} lanes into count '
               f'{info["parity"]} ({p.nobs} observer; packed: 2 c < B and '
               f'c nobs >= {tpeel.min_pack(dev)}); {n_dep} pairs deposit, '
               f'pairs differing {n_bad}, max |d tau| {dtau:.3e}, per-pair '
               f'deposits max rel err {dw:.3e}, cubes max abs err '
               f'{err:.3e} (atol 1e-5 x sum)')
    assert sorted(parities) == [0, 1], (label, parities)


def k4_k2_with_record(name, ch, meta, dev, r_max, seed, res):
    """K4 (its Stokes branch where the example sets use_stokes) and K2 (the
    birth triad, the launch flags) against their plain versions, with the
    peel record each writes."""
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport import refill, scatter
    for kname in ('scatter_lya', 'refill_point'):
        recs = {}

        def step(s, t, kernel):
            recs[kernel] = tpeel.PeelRecord.zeros(B_MAIN, dev)
            if kname == 'scatter_lya':
                (scatter.scatter if kernel else scatter.scatter_plain)(
                    s, t, ch.scatter_params, 7, 99, recs[kernel])
            else:
                (refill.refill if kernel else refill.refill_plain)(
                    s, t, ch.refill_params, 7, 12345, 10 ** 9, recs[kernel])
        tal = (('nscatt_gas', 'nscatt_events') if kname == 'scatter_lya'
               else ('Jin',))
        seed += 1
        _, _, frac, err, tdiff = both(meta, seed, step, tal, dev,
                                      r_max=r_max)
        n_rec, rerr = record_diff(recs[True], recs[False])
        assert n_rec <= MAX_FRAC * B_MAIN, n_rec
        _max_err(res, kname, max(err, rerr))
        sp = ch.scatter_params
        what = (f'Stokes {sp.stokes}, core-skip {sp.core_skip}'
                if kname == 'scatter_lya' else 'birth triad, launch flags')
        log(2, f'{kname} with the peel record on the {name} grid ({what}): '
               f'lanes differing {frac:.2e}, max abs err {err:.3e}; record '
               f'lanes differing {n_rec}, {int(recs[True].flag.sum())} '
               f'flagged, max abs err {rerr:.3e}; tallies max |d| {tdiff}')
    return seed


def phase2_dust(dev, res):
    """Dust on the grid of examples/DL2008/DL20e_dust.in as written (201^3,
    the 0.9 < r < 1 shell moving out at 200 km/s, DGR 1, a Gaussian line),
    with Stokes (the Mueller table) and without (Henyey-Greenstein), one
    observer on +z: K5 with rhokapD, K2's Gaussian births, K4's dust branch
    (+- use_reduced_wgt with Stokes) with its peel record, on lanes in the
    shell with xfreq up to 300 (the wing, where the dust wins the event
    split of this shell: rhokapD / rhokap = 2.7e-8), and K7 in mode dust,
    pair by pair."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.scatter import EVENT_DUST, EVENT_RESONANCE
    seed = 80
    for stokes in (True, False):
        t0 = time.time()
        cfg = example_params(DL20E_DUST, batch_size=B_MAIN, use_stokes=stokes,
                             **OBSERVER).resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        t_grid = time.time() - t0
        what = 'Stokes, Mueller' if stokes else 'no Stokes, HG'
        if stokes:
            _, _, frac, err, tal = both(meta, seed, fly_step(ch),
                                        ('Jout', 'Jmu', 'W_oor'), dev,
                                        nmu=ch.nmu, r_max=1.0)
            _max_err(res, 'fly_cartesian', err)
            log(2, f'K5 fly_cartesian, DL20e_dust 201^3 with rhokapD (grid '
                   f'built in {t_grid:.1f} s): lanes differing {frac:.2e}, '
                   f'max abs err {err:.3e}; tallies max |d| {tal}')
            _, sk, frac, err, tal = both(meta, seed + 1, refill_step(ch),
                                         ('Jin',), dev)
            _max_err(res, 'refill_point', err)
            log(2, f'K2 refill_point, Gaussian spectrum (sigma_x '
                   f'{ch.refill_params.sigma_x:.4f}): lanes differing '
                   f'{frac:.2e}, max abs err {err:.3e}, Jin max |d| '
                   f'{tal["Jin"]:.3e}')
        for reduced in ((False, True) if stokes else (False,)):
            seed += 2
            sp = dataclasses.replace(ch.scatter_params, reduced_wgt=reduced)
            recs = {}
            state = testing.dust_state(meta, grid, B_MAIN, seed, 300.0, dev)
            s0, sk, frac, err, tal = both(
                meta, seed, scatter_step(ch, sp, recs),
                ('nscatt_gas', 'nscatt_events', 'Jabs', 'nscatt_dust'), dev,
                state=state)
            n_rec, rerr = record_diff(recs[True], recs[False])
            assert n_rec <= MAX_FRAC * B_MAIN, n_rec
            _max_err(res, 'scatter_lya', max(err, rerr))
            flag = recs[True].flag
            n_dust, n_res = int((flag == EVENT_DUST).sum()), \
                int((flag == EVENT_RESONANCE).sum())
            n_abs = int((sk.phase == 0).sum())
            assert n_dust > 0.05 * B_MAIN and n_res > 0.05 * B_MAIN and (
                (n_abs == 0) == reduced), (n_dust, n_res, n_abs)
            log(2, f'K4 scatter_lya dust ({what}, reduced_wgt {reduced}) on '
                   f'the DL20e_dust grid: {n_res} resonance, {n_dust} dust '
                   f'scatterings, {n_abs} absorbed of {B_MAIN}; lanes '
                   f'differing {frac:.2e}, max abs err {err:.3e}; record '
                   f'lanes differing {n_rec}, max abs err {rerr:.3e}; '
                   f'tallies max |d| {tal}')
        seed += 2
        n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed, tpeel.DUST,
                                                dev, 1.0)
        _max_err(res, 'peel', err)
        log(2, f'K7 peel dust, DL20e_dust ({what}; 1 observer, '
               f'{ch.peel.obs_meta.nxim}x{ch.peel.obs_meta.nyim} x '
               f'{meta.nxfreq} bins): {n_dep} of {B_MAIN} pairs deposit, pairs '
               f'differing {n_bad}, max |d tau| {dtau:.3e}, per-pair deposits '
               f'max rel err {dw:.3e} (rtol 1e-5, all pairs), cubes max abs '
               f'err {err:.3e} (atol 1e-5 x sum)')
        del grid, ch


def flight_kernel(ch):
    """The name of the flight kernel of a chunk."""
    mod = type(ch.flight).__module__.rsplit('.', 1)[-1]
    if mod == 'fly_clump':
        return 'fly_clump_dense' if ch.flight.clump.dense else 'fly_clump_csr'
    return {'fly_slab': 'fly_uniform_slab', 'fly_sphere': 'fly_uniform_sphere',
            'fly_amr': 'fly_amr'}.get(mod, 'fly_cartesian')


def line_cases():
    """(label, Params, checks) of phase 2's metal-line cases: the examples
    as written (and the variants that reach a branch they do not), each
    with the kernels it holds against their plain versions: 'k2' the
    births (continuum, the branch shift), 'fly' the flight's line profile,
    'k4' the redistribution with and without recoil and its peel record,
    'k7' the peel in modes direct and resonance."""
    from lart_tpu_torch import testing
    ex, B = LINE_EXAMPLES, dict(batch_size=B_MAIN)
    si, fe, hd = ex['SiII_1193'], ex['FeII_UV1'], ex['HD']
    slab = dict(tau0=1e4, nz=201, batch=B_MAIN)
    return (
        ('SiII_1193 as written (type 5, 101^3, Hubble 200 km/s, continuum, '
         'recoil, Stokes, 1 observer)', example_params(si, **B),
         ('k2', 'fly', 'k4', 'k7')),
        ('SiII_1193 with a Voigt source (the birth shift to a level and a '
         'branch)', example_params(si, spectral_type='voigt', **B), ('k2',)),
        ('SiII_1193 without Stokes', example_params(si, use_stokes=False,
                                                    **B), ('k7',)),
        ('Mg II 2796 doublet (type 2) on the SiII_1193 grid, Voigt source',
         example_params(si, spectral_type='voigt', **MGII, **B),
         ('k2', 'fly', 'k4')),
        ('SiII_1527 t1e5tau1e1_V050 as written (type 4, 65^3, Hubble 50 km/s)',
         example_params(ex['SiII_1527'], **B), ('k2', 'k4')),
        ('FeII_UV1 as written but for recoil (type 5, 101^3 static ball '
         'without geometry sphere: K5 and the K7 walk; continuum, Stokes, 1 '
         'observer)', example_params(fe, recoil=True, **B),
         ('k2', 'fly', 'k7')),
        ('FeII_UV1 with geometry sphere and recoil (K6, the K7 chord)',
         example_params(fe, geometry='sphere', recoil=True, **B),
         ('fly', 'k7')),
        ('FeII_UV1 with geometry sphere and recoil, without Stokes',
         example_params(fe, geometry='sphere', recoil=True, use_stokes=False,
                        **B), ('k7',)),
        ('Mg II doublet on the FeII_UV1 sphere (K6)',
         example_params(fe, geometry='sphere', **MGII, **B), ('fly',)),
        ('HeI t4tau2 as written (type 6, 101^3 sphere)',
         example_params(ex['HeI'], **B), ('k2', 'fly', 'k4')),
        ('HeI pt_tau100_coh as written (type 6, HeI_coherent, Stokes)',
         example_params(ex['HeI_coherent'], save_peeloff=False, **B),
         ('k4',)),
        ('sphere_HD_dijkstra2006 as written (type 7, 101^3 reflect)',
         example_params(hd, **B), ('fly', 'k4')),
        ('sphere_HD_dijkstra2006 with geometry sphere, without xyz_symmetry '
         '(K6)', example_params(hd, xyz_symmetry=False, geometry='sphere',
                                **B), ('fly',)),
        ('slab 1x1x201 tau 1e4, Mg II doublet', testing.slab_params(
            line_id='MgII_2796', wavelength_min=2790.0,
            wavelength_max=2810.0, **slab), ('fly',)),
        ('slab 1x1x201 tau 1e4, Si II 1190/1193', testing.slab_params(
            line_id='SiII_1193', wavelength_min=1188.0,
            wavelength_max=1200.0, **slab), ('fly',)),
        ('slab 1x1x201 tau 1e4, H + D Ly-alpha (D/H 3e-5)',
         testing.slab_params(line_id='ly_alpha_HD', D_to_H_ratio=3e-5,
                             **slab), ('fly',)),
    )


def phase2_lines(dev, res):
    """The metal lines on the grids of their examples (line_cases): each
    new branch of K2, K3, K5, K6, K4 and K7 against its plain version at
    B = B_MAIN, lane by lane (K4 on lanes at a scattering with frequencies
    around the line's components, testing.line_state; with and without
    recoil, with its peel record) or pair by pair (K7, with per-lane phase
    weights in the record)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.physics import line as pline
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.scatter import EVENT_RESONANCE
    seed = 120
    for label, par, checks in line_cases():
        t0 = time.time()
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        lc = ch.scatter_params.line
        lt = f'line type {lc.line_type}'
        log(2, f'lines: {label}: {meta.nx}x{meta.ny}x{meta.nz}, '
               f'{meta.nxfreq} bins, flight {flight_kernel(ch)}, grid built '
               f'in {time.time() - t0:.1f} s')
        r_max = None if meta.nx == 1 else 1.0
        if 'k2' in checks:
            seed += 1
            _, _, frac, err, tal = both(meta, seed, refill_step(ch),
                                        ('Jin',), dev)
            _max_err(res, 'refill_point' + LINES, err)
            rp = ch.refill_params
            log(2, f'  K2 refill_point ({lt}, spectrum {rp.spectrum}, '
                   f'branch shift {rp.line.branch_init}): lanes differing '
                   f'{frac:.2e}, max abs err {err:.3e}, Jin max |d| '
                   f'{tal["Jin"]:.3e}')
        if 'fly' in checks:
            seed += 1
            name = flight_kernel(ch)
            _, _, frac, err, tal = both(meta, seed, fly_step(ch),
                                        ('Jout', 'Jmu', 'W_oor'), dev,
                                        nmu=ch.nmu, r_max=r_max)
            _max_err(res, name + LINES, err)
            log(2, f'  {name} ({lt} profile): lanes differing {frac:.2e}, '
                   f'max abs err {err:.3e}; tallies max |d| {tal}')
        if 'k4' in checks:
            sp0 = ch.scatter_params
            q = pline.line_prof(lc, sp0.a, sp0.Dfreq)
            offsets = [-d for d in q.dx[:max(lc.nup, 2)]]
            for recoil in (False, True):
                seed += 1
                sp = dataclasses.replace(sp0, recoil=recoil)
                recs = {}
                state = testing.line_state(meta, B_MAIN, seed, offsets,
                                           device=dev)
                _, sk, frac, err, tal = both(
                    meta, seed, scatter_step(ch, sp, recs),
                    ('nscatt_gas', 'nscatt_events'), dev, state=state)
                n_rec, rerr = record_diff(recs[True], recs[False])
                assert n_rec <= MAX_FRAC * B_MAIN, n_rec
                n_res = int((recs[True].flag == EVENT_RESONANCE).sum())
                assert n_res > 0.5 * B_MAIN, n_res
                _max_err(res, 'scatter_lya' + LINES, max(err, rerr))
                log(2, f'  K4 scatter_lya ({lt}, HeI_coherent '
                       f'{lc.he_coherent}, Stokes {sp.stokes}, recoil '
                       f'{recoil}): {n_res} of {B_MAIN} lanes scattered, '
                       f'lanes differing {frac:.2e}, max abs err {err:.3e}; '
                       f'record lanes differing {n_rec}, max abs err '
                       f'{rerr:.3e}; tallies max |d| {tal}')
        if 'k7' in checks:
            for mname, mode in (('direct', tpeel.DIRECT),
                                ('resonance', tpeel.RESONANCE)):
                seed += 2
                n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed, mode,
                                                        dev, r_max)
                _max_err(res, 'peel' + LINES, err)
                p = ch.peel
                walk = 'chord' if p.chord else 'DDA walk'
                log(2, f'  K7 peel {mname} ({lt}, {walk}, '
                       f'Stokes {p.stokes}, recoil {p.recoil}; '
                       f'{p.obs_meta.nxim}x{p.obs_meta.nyim} x '
                       f'{meta.nxfreq} bins): {n_dep} of {p.nobs * B_MAIN} '
                       f'pairs deposit, pairs differing {n_bad}, max |d tau| '
                       f'{dtau:.3e}, per-pair deposits max rel err {dw:.3e} '
                       f'(rtol 1e-5, all pairs), cubes max abs err {err:.3e}')
        del grid, ch


def phase2_lyb_h2(dev, res, batch=None):
    """Ly-beta (line type 8) on the grids of examples/ly_beta_sphere/
    t4tau1e4.in and t4tau1e4_dust.in as written (101^3, its observer), and
    H2 pumping on the grid of examples/h2_test/h2_on.in as written (101^3,
    core-skip) and of lya_HD/sphere_HD_dijkstra2006.in with H2 added (the
    kernels' metal-line instance): each new branch against its plain
    version at B = batch (B_MAIN), lane by lane or pair by pair.  K2's
    births (band 1); K5 with a third of the flying lanes in the H-alpha
    band (dust-only opacity, lab frequency, Jout_Ha, W_esc1/2) and with the
    H2 opacity; K4's conversions and the H-alpha band's dust events, and
    its H2 branch on lanes around the H2 lines; K7's conversion peel, the
    H-alpha band's dust peel, the band-1 resonance peel, and the H2
    sightline with an observer added to h2_on."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.scatter import (EVENT_CONVERSION,
                                                  EVENT_DUST)
    B = batch or B_MAIN
    seed = 300
    fly_tal = ('Jout', 'Jmu', 'W_oor')
    lyb_fly_tal = fly_tal + ('Jout_Ha', 'W_esc1', 'W_esc2')

    def band2(s):
        testing.band2_lanes(s, 7, frac=0.35)

    for rel, dust in ((LYB, False), (LYB_DUST, True)):
        t0 = time.time()
        cfg = example_params(rel, batch_size=B).resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        what = f'{Path(rel).name} (101^3, DGR {cfg.par.DGR:g})'
        log(2, f'ly_beta: {what}: grid built in {time.time() - t0:.1f} s')
        if not dust:
            seed += 1
            _, sk, frac, err, tal = both(meta, seed, refill_step(ch),
                                         ('Jin',), dev)
            launched = sk.phase != 0
            assert bool((sk.iband[launched] == 1).all())
            _max_err(res, 'refill_point' + LT8, err)
            log(2, f'  K2 refill_point (births in band 1): lanes differing '
                   f'{frac:.2e}, max abs err {err:.3e}, Jin max |d| '
                   f'{tal["Jin"]:.3e}')
        seed += 1
        s0 = testing.band2_lanes(testing.mixed_state(meta, B, seed, dev,
                                                     r_max=1.0), seed)
        _, sk, frac, err, tal = both(meta, seed, fly_step(ch), lyb_fly_tal,
                                     dev, nmu=ch.nmu, state=s0, lyb=True)
        _max_err(res, 'fly_cartesian' + LT8, err)
        log(2, f'  K5 fly_cartesian (line type 8, {int((s0.iband == 2).sum())}'
               f' lanes in the H-alpha band): lanes differing {frac:.2e}, '
               f'max abs err {err:.3e}; tallies max |d| {tal}')
        sp = ch.scatter_params
        for recoil in ((False, True) if not dust else (False,)):
            seed += 1
            recs = {}
            st = testing.line_state(meta, B, seed, [0.0], width=3.0,
                                    device=dev)
            testing.band2_lanes(st, seed, frac=0.35)
            tals = ('nscatt_gas', 'nscatt_events', 'W_conv') + (
                ('Jabs', 'Jabs_Ha', 'W_abs1', 'W_abs2', 'nscatt_dust')
                if dust else ())
            _, sk, frac, err, tal = both(
                meta, seed, scatter_step(ch, dataclasses.replace(
                    sp, recoil=recoil), recs), tals, dev, state=st,
                lyb=True)
            n_rec, rerr = record_diff(recs[True], recs[False])
            assert n_rec <= MAX_FRAC * B, n_rec
            flag = recs[True].flag
            n_conv = int((flag == EVENT_CONVERSION).sum())
            n_dust = int((flag == EVENT_DUST).sum())
            assert n_conv > 0.02 * B and (n_dust > 0.05 * B) == dust, (
                n_conv, n_dust)
            _max_err(res, 'scatter_lya' + LT8, max(err, rerr))
            log(2, f'  K4 scatter_lya (line type 8, recoil {recoil}): '
                   f'{n_conv} conversions, {n_dust} dust scatterings, '
                   f'{int((sk.phase == 0).sum())} absorbed of {B}; lanes '
                   f'differing {frac:.2e}, max abs err {err:.3e}; record '
                   f'lanes differing {n_rec}, max abs err {rerr:.3e}; '
                   f'tallies max |d| {tal}')
        modes = (('conversion', tpeel.CONVERSION, None),
                 ('resonance', tpeel.RESONANCE, None)) + (
            (('dust', tpeel.DUST, band2),) if dust else ())
        for mname, mode, prep in modes:
            seed += 2
            n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed, mode,
                                                    dev, 1.0, prep)
            _max_err(res, 'peel' + LT8, err)
            log(2, f'  K7 peel {mname} (line type 8, 51x51 x 121 bins): '
                   f'{n_dep} of {B} pairs deposit, pairs differing {n_bad}, '
                   f'max |d tau| {dtau:.3e}, per-pair deposits max rel err '
                   f'{dw:.3e} (rtol 1e-5, all pairs), cubes max abs err '
                   f'{err:.3e}')
        del grid, ch

    for label, par, peel_too in (
            ('h2_on as written (Ly-alpha, 101^3, tau 1e5, core-skip), one '
             'observer added for K7', example_params(H2_ON, batch_size=B,
                                                     **OBSERVER), True),
            ('sphere_HD_dijkstra2006 with H2 (line type 7, 101^3 reflect)',
             example_params(LINE_EXAMPLES['HD'], batch_size=B,
                            h2_model='neufeld', f_H2=0.03,
                            h2_temperature=8000.0), False)):
        t0 = time.time()
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        sp = ch.scatter_params
        lt = f'line type {sp.line.line_type}'
        key = H2 if sp.line.line_type == 1 else H2 + LINES
        log(2, f'H2: {label}: grid built in {time.time() - t0:.1f} s')
        # the two H2 lines' centres, x = dnu / D
        centres = [float(np.float32(d) / np.float32(sp.Dfreq))
                   for d in sp.h2.dnu]
        seed += 1
        # a third of the lanes in the H2 lines' wings
        s0 = testing.mixed_state(meta, B, seed, dev, r_max=1.0)
        rng = np.random.default_rng(seed)
        near = torch.as_tensor(rng.random(B) < 0.3, device=dev)
        xh = rng.choice(centres, B) + rng.normal(0.0, 1.5, B)
        s0.xfreq.copy_(torch.where(near, torch.as_tensor(
            xh, dtype=torch.float32, device=dev), s0.xfreq))
        _, _, frac, err, tal = both(meta, seed, fly_step(ch), fly_tal, dev,
                                    nmu=ch.nmu, state=s0, h2=True)
        _max_err(res, 'fly_cartesian' + key, err)
        log(2, f'  K5 fly_cartesian ({lt}, H2 opacity): lanes differing '
               f'{frac:.2e}, max abs err {err:.3e}; tallies max |d| {tal}')
        seed += 1
        recs = {}
        st = testing.line_state(meta, B, seed, centres + [0.0], width=1.5,
                                device=dev)
        _, sk, frac, err, tal = both(
            meta, seed, scatter_step(ch, sp, recs),
            ('nscatt_gas', 'nscatt_events', 'W_H2abs', 'W_H2scat',
             'W_H2pump'), dev, state=st, h2=True)
        n_rec, rerr = record_diff(recs[True], recs[False])
        assert n_rec <= MAX_FRAC * B, n_rec
        n_dead = int((sk.phase == 0).sum())
        assert n_dead > 0.01 * B, n_dead
        _max_err(res, 'scatter_lya' + key, max(err, rerr))
        log(2, f'  K4 scatter_lya ({lt}, H2): {n_dead} of {B} lanes '
               f'destroyed by H2; lanes differing {frac:.2e}, max abs err '
               f'{err:.3e}; record lanes differing {n_rec}; tallies max '
               f'|d| {tal}')
        if peel_too:
            for mname, mode in (('direct', tpeel.DIRECT),
                                ('resonance', tpeel.RESONANCE)):
                seed += 2
                n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed,
                                                        mode, dev, 1.0)
                _max_err(res, 'peel' + key, err)
                log(2, f'  K7 peel {mname} ({lt}, H2 sightline, '
                       f'{ch.peel.obs_meta.nxim}x{ch.peel.obs_meta.nyim} x '
                       f'{meta.nxfreq} bins): {n_dep} of {B} pairs deposit, '
                       f'pairs differing {n_bad}, max |d tau| {dtau:.3e}, '
                       f'per-pair deposits max rel err {dw:.3e}, cubes max '
                       f'abs err {err:.3e}')
        del grid, ch


def _in_core_fraction(s0, p):
    from lart_tpu_torch.transport.scatter import local_xcrit
    xc, _ = local_xcrit(s0, p)
    frac = float((s0.xfreq.abs() < xc).float().mean())
    assert frac > 0.0, 'no lane in the core: core-skip not exercised'
    return frac


def cuda_and_cpu(par, dev, amr_data=None):
    """driver.run of par (with amr_data, an AMR grid's leaves) on the card
    and on the CPU (one thread): (cuda RunResult, its wall s, its launch
    counts, cpu RunResult, its wall s).  The runs draw from the seeds 5 and
    6; a clump population is built from one seed, 82, in both."""
    from lart_tpu_torch import driver
    from lart_tpu_torch.kernels import build as kb
    kb.reset_launch_counts()
    t0 = time.time()
    rg = driver.run(par, device=dev, seed=5, amr_data=amr_data,
                    clump_seed=82)
    tg = time.time() - t0
    counts = {k: v for k, v in kb.LAUNCHES.items() if v}
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.time()
        rc = driver.run(par, device='cpu', seed=6, amr_data=amr_data,
                        clump_seed=82)
        tc = time.time() - t0
    finally:
        torch.set_num_threads(nthreads)
    return rg, tg, counts, rc, tc


def spectra_run(label, par, dev, amr_data=None):
    """driver.run on cuda and on cpu; the statistics of the two agree."""
    from lart_tpu_torch import testing
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev, amr_data)
    chi2, dmu = testing.spectra_agree(
        *testing.run_tallies(rg), *testing.run_tallies(rc), par.nphotons,
        par.nmu)
    log(3, f'{label}: <N> cuda {rg.nscatt_gas:.2f} ({tg:.1f} s) cpu '
           f'{rc.nscatt_gas:.2f} ({tc:.1f} s), chi2/dof {chi2:.2f}, Jmu max '
           f'|d| {dmu:.4f}, W_esc + W_oor {rg.W_escape + rg.W_oor:.6f} / '
           f'{rc.W_escape + rc.W_oor:.6f}; launches {counts}')
    if rg.peel is not None:
        peel_agree(label, rg, rc, par.nphotons)
    return counts


def peel_agree(label, rg, rc, nphotons):
    """The peel cubes of a cuda and a cpu run agree statistically: each
    observer's peeled flux within 3 sigma of the other's (sigma from
    testing.PEEL_V_PHOTON), the normalized peel spectra's chi2/dof < 3
    and, with Stokes, the ring profile of Q/I chi2/dof < 3."""
    from lart_tpu_torch import testing
    tol = 3.0 * np.sqrt(2.0 * testing.PEEL_V_PHOTON / nphotons)
    cg, cc = testing.peel_closure(rg), testing.peel_closure(rc)
    out = []
    for o, (a, b) in enumerate(zip(cg, cc)):
        chi2, nb = testing.peel_spectra_chi2(rg, rc, o, nphotons)
        pol = testing.ring_polarization_chi2(rg, rc, o) \
            if 'Q' in rg.peel else float('nan')
        assert abs(a - b) <= tol and chi2 < 3.0 and not pol >= 3.0, (
            o, a, b, tol, chi2, pol)
        out.append(f'observer {o}: 4 pi d^2 flux / W_esc cuda {a:.4f} cpu '
                   f'{b:.4f} (|d| <= {tol:.4f}), spectrum chi2/dof '
                   f'{chi2:.2f} over {nb} bins, ring Q/I chi2/dof {pol:.2f}')
    log(3, f'{label} peel: ' + '; '.join(out))
    return cg


def dust_run(label, par, dev):
    """driver.run on cuda and on cpu of a dusty config: the weight closes
    in each (W_esc + W_abs + W_oor to 1e-3); the absorbed weight within 3
    sigma of its binomial spread, the escaped and absorbed spectra's shapes
    chi2/dof < 3, the gas and dust scatterings per photon and, with an
    observer, the peeled flux closure and Stokes I within 3 sigma of their
    per-photon spreads on the dusty shell (testing.DUST_V_*,
    PEEL_V_DUST)."""
    from lart_tpu_torch import testing
    n = par.nphotons
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev)
    for r in (rg, rc):
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (r.W_escape, r.W_absorb, r.W_oor)
    p = 0.5 * (rg.W_absorb + rc.W_absorb)
    assert abs(rg.W_absorb - rc.W_absorb) <= 3 * np.sqrt(2 * p * (1 - p) / n)
    chi2 = {k: testing.spectra_chi2(getattr(rg, k), getattr(rc, k),
                                    n * getattr(rg, w), n * getattr(rc, w))[0]
            for k, w in (('Jout', 'W_escape'), ('Jabs', 'W_absorb'))}
    assert max(chi2.values()) < 3.0, chi2
    for a, b, v in ((rg.nscatt_gas, rc.nscatt_gas, testing.DUST_V_NSCATT),
                    (rg.nscatt_dust, rc.nscatt_dust, testing.DUST_V_NDUST)):
        assert abs(a / b - 1.0) < 3.0 * np.sqrt(2.0 * v / n), (a, b)
    peel = ''
    if rg.peel is not None:
        sig = np.sqrt(testing.PEEL_V_DUST / n)
        cg, cc = testing.peel_closure(rg)[0], testing.peel_closure(rc)[0]
        ig, ic = (float(r.peel['I'].sum()) for r in (rg, rc))
        assert abs(cg - 1.0) < 3 * sig and abs(cc - 1.0) < 3 * sig, (cg, cc)
        assert abs(ig / ic - 1.0) < 3 * np.sqrt(2.0) * sig, (ig, ic)
        peel = (f'; 4 pi d^2 flux / W_esc cuda {cg:.4f} cpu {cc:.4f}, Stokes '
                f'I {ig:.4f} / {ic:.4f} (3 sigma {3 * sig:.4f})')
    log(3, f'{label}: W_esc + W_abs + W_oor cuda {rg.W_escape:.6f} + '
           f'{rg.W_absorb:.6f} + {rg.W_oor:.6f} ({tg:.1f} s), cpu '
           f'{rc.W_escape:.6f} + {rc.W_absorb:.6f} + {rc.W_oor:.6f} ('
           f'{tc:.1f} s); <N> gas {rg.nscatt_gas:.3f} / {rc.nscatt_gas:.3f},'
           f' dust {rg.nscatt_dust:.4f} / {rc.nscatt_dust:.4f}; chi2/dof '
           f'Jout {chi2["Jout"]:.2f} Jabs {chi2["Jabs"]:.2f}{peel}; launches '
           f'{counts}')
    return counts


def lyb_run(label, par, dev):
    """driver.run on cuda and on cpu of a Ly-beta config with one observer:
    in each, W_esc1 + W_abs1 + W_conv = 1 and W_esc2 + W_abs2 = W_conv to
    1e-3, W_conv / nscatt_gas within 0.02 of P_down[1] = 0.11834 and the
    H-alpha cube's flux closure (4 pi d^2 flux / W_esc2) within 3 sigma of
    testing.PEEL_V_PHOTON; between them W_conv within 3 sigma of its
    binomial spread and the H-alpha spectra's shapes chi2/dof < 3."""
    from lart_tpu_torch import testing
    n = par.nphotons
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev)
    tol = 3.0 * np.sqrt(testing.PEEL_V_PHOTON / n)
    ha = []
    for r in (rg, rc):
        assert abs(r.W_esc1 + r.W_abs1 + r.W_conv - 1.0) < 1e-3
        assert abs(r.W_esc2 + r.W_abs2 - r.W_conv) < 1e-3
        assert abs(r.W_conv / r.nscatt_gas - 0.11834) < 0.02
        (c,) = testing.peel_closure(r, ('Ha',), r.W_esc2)
        assert abs(c - 1.0) < tol, c
        ha.append(c)
    p = 0.5 * (rg.W_conv + rc.W_conv)
    assert abs(rg.W_conv - rc.W_conv) <= 3.0 * np.sqrt(2.0 * p * (1 - p) / n)
    chi2, nb = testing.spectra_chi2(rg.Jout_Ha, rc.Jout_Ha, n * rg.W_esc2,
                                    n * rc.W_esc2)
    assert chi2 < 3.0, chi2
    log(3, f'{label}: W_esc1 + W_abs1 + W_conv cuda {rg.W_esc1:.6f} + '
           f'{rg.W_abs1:.6f} + {rg.W_conv:.6f} ({tg:.1f} s), cpu '
           f'{rc.W_esc1:.6f} + {rc.W_abs1:.6f} + {rc.W_conv:.6f} ('
           f'{tc:.1f} s); W_esc2 + W_abs2 {rg.W_esc2:.6f} + {rg.W_abs2:.6f}'
           f' / {rc.W_esc2:.6f} + {rc.W_abs2:.6f}; W_conv / nscatt_gas '
           f'{rg.W_conv / rg.nscatt_gas:.4f} / {rc.W_conv / rc.nscatt_gas:.4f}'
           f'; Jout_Ha chi2/dof {chi2:.2f} over {nb} bins; 4 pi d^2 Ha flux '
           f'/ W_esc2 {ha[0]:.4f} / {ha[1]:.4f} (|d - 1| < {tol:.4f}); '
           f'launches {counts}')
    return counts


def h2_run(label, par, dev):
    """driver.run on cuda and on cpu of an H2 config: in each, W_esc +
    W_oor + W_H2abs = 1 to 1e-3; between them W_H2abs within 3 sigma of
    its binomial spread, the scatterings per photon within 5% and the
    escaped spectra's shapes chi2/dof < 3."""
    from lart_tpu_torch import testing
    n = par.nphotons
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev)
    for r in (rg, rc):
        assert abs(r.W_escape + r.W_oor + r.W_H2abs - 1.0) < 1e-3
    p = 0.5 * (rg.W_H2abs + rc.W_H2abs)
    assert abs(rg.W_H2abs - rc.W_H2abs) <= 3.0 * np.sqrt(
        2.0 * p * (1 - p) / n), (rg.W_H2abs, rc.W_H2abs)
    assert abs(rg.nscatt_gas / rc.nscatt_gas - 1.0) < 0.05
    chi2, nb = testing.spectra_chi2(rg.Jout, rc.Jout, n * rg.W_escape,
                                    n * rc.W_escape)
    assert chi2 < 3.0, chi2
    log(3, f'{label}: W_esc + W_oor + W_H2abs cuda {rg.W_escape:.6f} + '
           f'{rg.W_oor:.6f} + {rg.W_H2abs:.6f} ({tg:.1f} s), cpu '
           f'{rc.W_escape:.6f} + {rc.W_oor:.6f} + {rc.W_H2abs:.6f} ('
           f'{tc:.1f} s); W_H2pump {rg.W_H2pump} / {rc.W_H2pump}; <N> '
           f'{rg.nscatt_gas:.3f} / {rc.nscatt_gas:.3f}; Jout chi2/dof '
           f'{chi2:.2f} over {nb} bins; launches {counts}')
    return counts


def phase3_process(dev):
    """Phase 3 in a process of its own, spawned, running beside phase 4;
    it exits non-zero if a check fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    torch.cuda.set_device(dev)
    phase3(dev)


def phase3(dev):
    from lart_tpu_torch import testing
    # the slab, the spheres and the peel spheres at tau0 20-50: their CPU
    # runs cost ~0.6 s a unit of tau0 there (more on a slow host), and the
    # script's time limit covers every phase
    c = spectra_run('slab tau0=20 1e4 photons', testing.slab_params(
        tau0=20.0, nz=101, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_uniform_slab',
                                  'scatter_lya')), c
    c = spectra_run('sphere 33^3 tau0=40 1e4 photons', testing.sphere_params(
        tau0=40.0, n=33, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_uniform_sphere',
                                  'scatter_lya')), c
    c = spectra_run('Hubble sphere 33^3 xyz_symmetry Vexp 200 tau0=100 '
                    '1e4 photons', testing.hubble_params(
                        tau0=100.0, n=33, nphotons=10_000, batch=4096), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_cartesian',
                                  'scatter_lya')), c
    # peel-off to two observers (+z and oblique), 17 x 17 images
    c = spectra_run('sphere 17^3 tau0=20 1e4 photons, Stokes peel',
                    testing.peel_params(testing.sphere_params(
                        tau0=20.0, n=17, nphotons=10_000, batch=4096),
                        nim=17), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_uniform_sphere',
                                  'scatter_lya', 'peel')), c
    c = spectra_run('Hubble sphere 17^3 xyz_symmetry tau0=50 1e4 photons, '
                    'peel without Stokes', testing.peel_params(
                        testing.hubble_params(tau0=50.0, n=17,
                                              nphotons=10_000, batch=4096),
                        stokes=False, nim=17), dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_cartesian',
                                  'scatter_lya', 'peel')), c
    # the dusty expanding shell, Mueller dust with Stokes, one observer
    par = dataclasses.replace(
        testing.peel_params(testing.dust_params(nphotons=4000), nim=17),
        alpha=(0.0,), beta=(0.0,))
    c = dust_run('dusty shell 17^3 (testing.dust_params) 4000 photons, '
                 'Mueller dust, Stokes peel', par, dev)
    assert all(c.get(k) for k in ('refill_point', 'fly_cartesian',
                                  'scatter_lya', 'peel')), c
    # the metal lines: 17^3 uniform spheres (testing.line_params) of the
    # Mg II doublet, the Si II multiplet with Stokes, recoil and one
    # observer, and H + D Ly-alpha (D/H 3e-3)
    for case, over in (('doublet', {}),
                       ('multiplet', dict(spectral_type='voigt',
                                          use_stokes=True)),
                       ('hd', dict(D_to_H_ratio=3e-3, tau0=10.0))):
        par = testing.line_params(case, n=17, nphotons=10_000, batch=4096,
                                  save_Jmu=True, nmu=8,
                                  **{'tau0': 20.0, **over})
        need = ('refill_point', 'fly_uniform_sphere', 'scatter_lya')
        if case == 'multiplet':
            par = dataclasses.replace(testing.peel_params(par, nim=17),
                                      alpha=(0.0,), beta=(0.0,))
            need += ('peel',)
        c = spectra_run(f'{testing.LINE_CASES[case][0]} sphere 17^3 tau0 '
                        f'{par.taumax:g} 1e4 photons{over}', par, dev)
        assert all(c.get(k) for k in need), c
    # Ly-beta with dust (DGR 1e5: a dust tau of ~0.5) and one observer;
    # Ly-alpha with H2 pumping (f_H2 30, so that H2 destroys a share)
    need = ('refill_point', 'fly_cartesian', 'scatter_lya')
    par = dataclasses.replace(
        testing.lyb_params(tau0=30.0, n=17, nphotons=5000, batch=4096,
                           DGR=1e5), save_peeloff=True, nobs=1, nxim=17,
        nyim=17, distance=1e3, alpha=(0.0,), beta=(0.0,))
    c = lyb_run('Ly-beta sphere 17^3 tau0 30, DGR 1e5, 5000 photons, one '
                'observer', par, dev)
    assert all(c.get(k) for k in need + ('peel',)), c
    c = h2_run('H2 sphere 17^3 tau0 10, f_H2 30, 4000 photons',
               testing.h2_params(tau0=10.0, n=17, nphotons=4000, batch=4096,
                                 f_H2=30.0), dev)
    assert all(c.get(k) for k in need), c
    amr_phase3(dev)
    clump_phase3(dev)
    inside_phase3(dev)


def run_cli(nml, out, device='cuda'):
    """(rc, RunResult, wall s, launch counts) of the CLI on nml; the
    RunResult is caught on its way from driver.run to the writer."""
    from lart_tpu_torch import __main__ as cli
    from lart_tpu_torch import driver
    from lart_tpu_torch.kernels import build as kb
    caught = []
    run = driver.run

    def keep(*a, **k):
        caught.append(run(*a, **k))
        return caught[-1]

    driver.run = keep
    try:
        kb.reset_launch_counts()
        t0 = time.time()
        rc = cli.main([str(nml), str(out), '--device', device])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kb.LAUNCHES)
    finally:
        driver.run = run
    return rc, caught[0], wall, launches


def phase4(tauhomo=3e3, device='cuda'):
    """The main paths, through the CLI's entry point, with launch counts."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.writer import read_spectrum
    total = {}

    def add(launches, need):
        add_launches(total, launches, need)

    with tempfile.TemporaryDirectory() as tmp:
        # the Neufeld slab
        nml = namelist_variant('slab/t1tau6.in', tmp, tauhomo=f'{tauhomo:g}',
                               batch_size=B_MAIN,
                               nphotons=f'{SLAB_PHOTONS:g}')
        out = Path(tmp) / 't1tau4.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        nph, w_esc, nsc = (float(spec[k]) for k in ('nphotons', 'W_esc',
                                                     'Nsc_gas'))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == spec['Xfreq'].shape
        assert abs(w_esc - 1.0) < 1e-3, w_esc
        add(launches, ('refill_point', 'fly_uniform_slab', 'scatter_lya'))
        log(4, f'CLI t1tau6.in (tauhomo {tauhomo:g}, {nph:.0f} photons, '
               f'B={B_MAIN}, FITS): W_esc {w_esc:.6f}, <N_scatt> {nsc:.2f}, '
               f'wall {wall:.1f} s; launches {launches}')

        # the Dijkstra sphere acceptance case dijkstra_tau1e5_T1e4
        nml = namelist_variant('sphere/t4tau7.in', tmp, taumax='1e5',
                               nphotons=DIJKSTRA_PHOTONS)
        out = Path(tmp) / 'dijkstra.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        x = np.asarray(spec['Xfreq'], np.float64)
        jout = np.asarray(spec['Jout'], np.float64)
        w_esc, nph = float(spec['W_esc']), float(spec['nphotons'])
        atau0 = float(spec['voigta']) * float(spec['taumax'])
        chi2, chi2_raw, ndof, pm, _ = testing.shape_chi2(
            x, jout, testing.dijkstra_J(x, atau0), nph, atau0=atau0)
        xp_model = abs(x[np.argmax(pm)])
        xp_exact = 0.92 * atau0 ** (1.0 / 3.0)
        xp_tol = testing.XPEAK_RTOL + 0.5 * testing.SYS_COEF \
            * atau0 ** (-1.0 / 3.0)
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        assert abs(w_esc - 1.0) < 1e-3, w_esc
        assert chi2 / ndof < testing.CHI2_DOF_MAX, chi2 / ndof
        assert abs(xp_model / xp_exact - 1.0) < xp_tol, (xp_model, xp_exact)
        add(launches, ('refill_point', 'fly_uniform_sphere', 'scatter_lya'))
        log(4, f'CLI t4tau7.in as dijkstra_tau1e5_T1e4 (taumax 1e5, {nph:.0f}'
               f' photons, 129^3, core-skip, FITS): W_esc {w_esc:.6f}, '
               f'<N_scatt> {float(spec["Nsc_gas"]):.2f}, a tau0 {atau0:.2f},'
               f' shape chi2/dof {chi2 / ndof:.3f} (raw {chi2_raw / ndof:.3f}'
               f', {ndof} bins, limit {testing.CHI2_DOF_MAX}), peak '
               f'{xp_model:.3f} vs {xp_exact:.3f} (rel {xp_model / xp_exact - 1:+.4f},'
               f' tol {xp_tol:.4f}), wall {wall:.1f} s; launches {launches}')

        # the expanding Hubble sphere at its full 201^3 grid
        nml = source_variant('vel_effect_cut', tmp)
        out = Path(tmp) / 'vel_effect.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        x = np.asarray(spec['Xfreq'], np.float64)
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        assert float(spec['W_esc']) == res.W_escape
        w = res.W_escape + res.W_oor
        assert abs(w - 1.0) < 1e-3, (res.W_escape, res.W_oor)
        red = float(jout[x < 0].sum() / jout.sum())
        add(launches, ('refill_point', 'fly_cartesian', 'scatter_lya'))
        log(4, f'CLI t4NHI2_20_V0200.in (N_HI 5e17, {res.nphotons} photons, '
               f'201^3 reflect, Hubble Vexp 200, FITS): W_esc {res.W_escape:.6f}'
               f' + W_oor {res.W_oor:.6f} = {w:.6f}, share of escaped weight '
               f'at x < 0 (red) {red:.4f}, <N_scatt> {res.nscatt_gas:.2f}, '
               f'wall {wall:.1f} s; launches {launches}')

        peel_cli(tmp, device, total)
        dl2008_cli(tmp, device, total)
        lines_cli(tmp, device, total)
        lyb_h2_cli(tmp, device, total)
        amr_runs(tmp, device, total)
        clump_cli(tmp, device, total)
        inside_cli(tmp, device, total)
        sources_cli(tmp, device, total)
        temperature_cli(tmp, device, total)
        atmosphere_cli(tmp, device, total)
        shear_cli(tmp, device, total)
        allph_cli(tmp, device, total)
    return total


def add_launches(total, launches, need):
    """Assert that each kernel in `need` was launched, and add the counts
    into total."""
    for k in need:
        assert launches[k] > 0, (k, launches)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def peel_cli(tmp, device, total):
    """The three peel-off examples through the CLI, as written but for
    their photons: weight, the _peel3D files, the sphere's flux closure."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum
    for name, over, fly in (
            ('slab_peel', cut_of('slab_peel_cut'), 'fly_uniform_slab'),
            ('sphere_peel', cut_of('sphere_peel_cut'), 'fly_uniform_sphere'),
            ('vel_effect_peel', cut_of('vel_effect_peel_cut'),
             'fly_cartesian')):
        nml = namelist_variant(PEEL_EXAMPLES[name], tmp, **over)
        out = Path(tmp) / f'{name}.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        assert float(spec['W_esc']) == res.W_escape
        w = res.W_escape + res.W_oor
        assert abs(w - 1.0) < 1e-3, (name, res.W_escape, res.W_oor)
        stokes = res.cfg.par.use_stokes
        want = {'Scattered', 'Direct', 'RadialI'} | (
            {'Stokes_I', 'Stokes_Q', 'Stokes_U', 'Stokes_V',
             'Stokes_radial'} if stokes else set())
        with open_read(str(Path(tmp) / f'{name}_peel3D.fits')) as f:
            assert want <= set(f.keys()), (name, sorted(f.keys()))
            shape = np.asarray(f['Scattered/data']).shape
        om = res.obs_meta
        assert shape == (res.meta.nxfreq, om.nxim, om.nyim), shape
        closure = testing.peel_closure(res)
        if name == 'sphere_peel':
            # a central source in a uniform sphere: isotropic
            assert abs(closure[0] - 1.0) < 0.05, closure
        add_launches(total, launches, ('refill_point', fly, 'scatter_lya',
                                      'peel'))
        log(4, f'CLI {Path(PEEL_EXAMPLES[name]).name} ({over}, '
               f'{res.nphotons} photons, Stokes {stokes}, FITS): W_esc '
               f'{res.W_escape:.6f} + W_oor {res.W_oor:.6f} = {w:.6f}, '
               f'<N_scatt> {res.nscatt_gas:.2f}, 4 pi d^2 peeled flux / '
               f'W_esc {closure[0]:.4f}, _peel3D {shape}, wall '
               f'{wall:.1f} s; launches {launches}')


def dl2008_cli(tmp, device, total, nphotons=DL_PHOTONS):
    """The Dijkstra & Loeb (2008) expanding shell as written (201^3, 200
    km/s, a Gaussian line, Stokes) but for its photons and its column, with
    dust (DL20e_dust.in, with the all-photons table: allph_check) and
    without (DL20e.in): the weight closes and the
    escaped spectrum is red-dominated (the receding far side of the
    shell).  N_HI is cut from 1e20 to 1e18 (tau0 5.9e6 to 5.9e4) with
    dust, DGR raised from 1 to 100, so the dust's optical depth stays 0.16
    as written, and to 2e17 without (testing.SOURCE_CASES['DL20e_cut']):
    as written, a few percent of the photons scatter into the shell's line
    core and random-walk ~tau0 times, and 2000 photons still had 12 alive
    after 200 s (even with core-skip) on an H100."""
    for rel in (DL20E_DUST, DL20E):
        over = {'no_photons': f'{nphotons:g}', 'N_HI': '1.0e18'}
        if rel == DL20E_DUST:
            # with the all-photons table (testing.SOURCE_CASES[
            # 'DL20e_dust_allph']): its Stokes columns and absorption deaths
            over.update(cut_of('DL20e_dust_allph'))
        else:
            over.update(cut_of('DL20e_cut'))
        nml = namelist_variant(rel, tmp, **over)
        out = Path(tmp) / (Path(rel).stem + '.fits')
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        if rel == DL20E_DUST:
            allph_check('DL20e_dust', res, out, wall, launches, total,
                        'fly_cartesian')
        x, jout = res.xfreq, res.Jout
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        w = res.W_escape + res.W_absorb + res.W_oor
        assert abs(w - 1.0) < 1e-3, (rel, res.W_escape, res.W_absorb,
                                     res.W_oor)
        red = float(jout[x < 0].sum() / jout.sum())
        assert red > 0.5, red
        dust = res.cfg.par.DGR > 0.0
        if dust:
            assert res.W_absorb > 0.0 and res.Jabs is not None
        add_launches(total, launches, ('refill_point', 'fly_cartesian',
                                       'scatter_lya'))
        log(4, f'CLI {Path(rel).name} ({res.nphotons} photons, 201^3, '
               f'N_HI {res.cfg.par.N_HI:g}, DGR {res.cfg.par.DGR:g}, Stokes, FITS): W_esc {res.W_escape:.6f} + W_abs '
               f'{res.W_absorb:.6f} + W_oor {res.W_oor:.6f} = {w:.6f}, '
               f'absorbed share {res.W_absorb:.6f}, share of escaped weight '
               f'at x < 0 (red) {red:.4f}, <N_scatt> {res.nscatt_gas:.2f}, '
               f'dust events {res.nscatt_dust:.4f}, wall {wall:.1f} s; '
               f'launches {launches}')


def fluorescent_excess(res):
    """The escaped spectrum's mean weight per bin in the Si II* lines (each
    fluorescent branch's centre, -delE_i / D - Elow / D, +- 3 Doppler
    widths) over its mean in the continuum (the bins farther than the
    outflow's speed + 10 Doppler widths from every line centre)."""
    from lart_tpu_torch.physics import line as pline
    lc = pline.LineConsts.from_config(res.cfg)
    D = res.meta.Dfreq_ref
    q = pline.line_prof(lc, res.meta.voigt_a_ref, D)
    res_c = [-d for d in q.dx[:lc.nup]]
    fl_c = [-q.dx[i] - pline.div32(lc.Elow_Hz[i][j], D)
            for i in range(lc.nup) for j in range(1, lc.ndown[i])]
    x, J = res.xfreq, res.Jout
    reach = abs(res.cfg.par.Vexp) / res.cfg.vtherm + 10.0
    far = np.ones_like(x, dtype=bool)
    for c in res_c + fl_c:
        far &= np.abs(x - c) > reach
    line = np.zeros_like(far)
    for c in fl_c:
        line |= np.abs(x - c) < 3.0
    assert far.sum() >= 10 and line.sum() >= 2, (far.sum(), line.sum())
    return float(J[line].mean() / J[far].mean()), fl_c


def lines_cli(tmp, device, total, hd_photons=HD_PHOTONS):
    """The metal-line examples through the CLI: SiII_1193/tau1e+2_V200 as
    written (the weight closes, the Si II* fluorescent lines stand above
    the continuum, the _peel3D FITS is written), sphere_HD_dijkstra2006
    with its photons cut to hd_photons and N_HI to HD_NHI (~8e5
    scatterings a photon as written), HeI t4tau2 and SiII_1527
    t1e5tau1e1_V050 as written.  The
    launch counts of these runs go into total['lines']."""
    from lart_tpu_torch.io.iofile import open_read
    lines = total.setdefault('lines', {})
    ex = LINE_EXAMPLES
    for key, over, fly in (
            ('SiII_1193', {}, 'fly_cartesian'),
            ('HD', dict(no_photons=f'{hd_photons:g}', N_HImax=HD_NHI),
             'fly_cartesian'),
            ('HeI', {}, 'fly_uniform_sphere'),
            ('SiII_1527', {}, 'fly_cartesian')):
        nml = namelist_variant(ex[key], tmp, **over)
        out = Path(tmp) / f'{key}.fits'
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        x, jout = res.xfreq, res.Jout
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        w = res.W_escape + res.W_oor
        assert abs(w - 1.0) < 1e-3, (key, res.W_escape, res.W_oor)
        need = ('refill_point', fly, 'scatter_lya')
        extra = ''
        if key == 'SiII_1193':
            need += ('peel',)
            ratio, centres = fluorescent_excess(res)
            assert ratio > 1.1, (ratio, centres)
            om = res.obs_meta
            with open_read(str(Path(tmp) / f'{key}_peel3D.fits')) as f:
                shape = np.asarray(f['Scattered/data']).shape
            assert shape == (res.meta.nxfreq, om.nxim, om.nyim), shape
            extra = (f', Si II* lines at x = '
                     f'{", ".join(f"{c:.2f}" for c in centres)} stand '
                     f'{ratio:.3f} x the continuum, _peel3D {shape}')
        add_launches(total, launches, need)
        for k, v in launches.items():
            lines[k] = lines.get(k, 0) + v
        log(4, f'CLI {Path(ex[key]).name} ({over or "as written"}, '
               f'{res.nphotons} photons, line type '
               f'{res.cfg.line.line_type}, FITS): W_esc {res.W_escape:.6f} '
               f'+ W_oor {res.W_oor:.6f} = {w:.6f}, <N_scatt> '
               f'{res.nscatt_gas:.2f}{extra}, wall {wall:.1f} s; launches '
               f'{launches}')


def lyb_h2_cli(tmp, device, total):
    """The slice's examples through the CLI (FITS), h2_on.in at taumax 1e4,
    the others as written: Ly-beta
    t4tau1e4.in and t4tau1e4_dust.in (the band budgets close, W_conv /
    nscatt_gas is P_down[1], the Spectrum keywords, Jout_Ha, Jabs_Ha, J2gam
    and the _peel3D file's peel_Ha cube are written), and h2_on.in (the
    weight closes with H2's destroyed share; the H2 keywords).  The launch
    counts of the Ly-beta runs go into total['lyb'], h2_on's into
    total['h2']."""
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum
    for rel, key in ((LYB, 'lyb'), (LYB_DUST, 'lyb'), (H2_ON, 'h2')):
        # h2_on.in at taumax 1e4 (testing.SOURCE_CASES['h2_on_cut'])
        nml = namelist_variant(rel, tmp, **(cut_of('h2_on_cut')
                                            if key == 'h2' else {}))
        out = Path(tmp) / (Path(rel).stem + '.fits')
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        x, jout = res.xfreq, res.Jout
        assert np.all(np.isfinite(jout)) and jout.shape == x.shape
        need = ('refill_point', 'fly_cartesian', 'scatter_lya')
        if key == 'lyb':
            need += ('peel',)
            w1 = res.W_esc1 + res.W_abs1 + res.W_conv
            w2 = res.W_esc2 + res.W_abs2
            assert abs(w1 - 1.0) < 1e-3 and abs(w2 - res.W_conv) < 1e-3, (
                w1, w2, res.W_conv)
            pconv = res.W_conv / res.nscatt_gas
            assert abs(pconv - 0.11834) < 0.02, pconv
            assert float(spec['W_conv']) == res.W_conv
            with open_read(str(out)) as f:
                assert {'Jout_Ha', 'Jabs_Ha', 'J2gam'} <= set(f.keys())
                ha = np.asarray(f['Jout_Ha/data'])
            with open_read(str(Path(tmp) / f'{Path(rel).stem}_peel3D.fits')
                           ) as f:
                cube = np.asarray(f['peel_Ha/data'])
            om = res.obs_meta
            assert cube.shape == (res.meta.nxfreq, om.nxim, om.nyim)
            assert ha.sum() > 0.0 and cube.sum() > 0.0
            extra = (f'W_esc1 {res.W_esc1:.6f} + W_abs1 {res.W_abs1:.6f} + '
                     f'W_conv {res.W_conv:.6f} = {w1:.6f}, W_esc2 '
                     f'{res.W_esc2:.6f} + W_abs2 {res.W_abs2:.6e} = W_conv '
                     f'to {abs(w2 - res.W_conv):.1e}, W_conv / nscatt_gas '
                     f'{pconv:.5f}, peel_Ha {cube.shape}')
        else:
            w = res.W_escape + res.W_oor + res.W_H2abs
            assert abs(w - 1.0) < 1e-3, (res.W_escape, res.W_oor,
                                         res.W_H2abs)
            assert str(spec['H2MODEL']).strip() == 'neufeld'
            assert float(spec['H2ABS']) == res.W_H2abs > 0.0
            extra = (f'W_esc {res.W_escape:.6f} + W_oor {res.W_oor:.6f} + '
                     f'W_H2abs {res.W_H2abs:.6f} = {w:.6f}, W_H2scat '
                     f'{res.W_H2scat:.6f}, W_H2pump {res.W_H2pump}')
        add_launches(total, launches, need)
        sub = total.setdefault(key, {})
        for k, v in launches.items():
            sub[k] = sub.get(k, 0) + v
        log(4, f'CLI {Path(rel).name} '
               f'{"at taumax 1e4" if key == "h2" else "as written"} '
               f'({res.nphotons} photons, '
               f'{res.meta.nx}^3, line type {res.cfg.line.line_type}, FITS):'
               f' {extra}, <N_scatt> {res.nscatt_gas:.2f}, wall {wall:.1f} '
               f's; launches {launches}')


def amr_leaves(name):
    """The leaf dict of an AMR grid of this slice, made in-process (the
    card's machine has no h5py): 'sphere48k' is make_amr_sphere(32, 1),
    which examples/amr_sphere/amr_sphere.h5 holds column for column,
    'sphere3M' make_amr_sphere(AMR_BIG, 1), 'gaps' the 48k sphere with 5% of
    its finest leaves dropped (gap cells), 'jellyfish' the leaves of
    examples/jellyfish_rmhd/mk_amr.py (testing.jellyfish_amr)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.amr import make_amr_sphere
    if name == 'jellyfish':
        return testing.jellyfish_amr()
    if name == 'sphere3M':
        return make_amr_sphere(AMR_BIG, 1)
    leaves = make_amr_sphere(32, 1)
    return testing.amr_gaps(leaves, 0.05, 1) if name == 'gaps' else leaves


def amr_chunk(par, data, dev):
    """(meta, chunk, seconds, builder) of par's AMR grid built on dev from
    the leaves data; builder is 'native' where the C++ octree builder
    built the tree."""
    from lart_tpu_torch.grid.amr import build_amr
    from lart_tpu_torch.transport.engine import make_chunk
    cfg = par.resolve()
    t0 = time.time()
    r = build_amr(cfg, data=data, device=dev)
    ch = make_chunk(cfg, r.meta, r.dev)
    return r.meta, ch, time.time() - t0, r.tree.builder


def phase2_amr(dev, res, batch=None):
    """The octree AMR backend: K8 and the AMR branches of K2, K4 and K7
    against their plain versions at B = batch (B_MAIN), lane by lane or
    pair by pair, from mixed AMR states (lanes in leaves, in gap cells and
    on node faces; testing.amr_state).  The grids: the 3.06M-leaf sphere
    (make_amr_sphere(AMR_BIG, 1), 256^3 fine map) with its fine map and
    with the octant descent, K4 with local core-skip and K7 with an
    observer on +z; the jellyfish_pt grid as written (non-uniform T, a
    moving medium, dust, core-skip, its observer), with the fine map and
    with the descent; and the 48k-leaf sphere with 5% gap cells in the
    Mg II doublet (K8's and K4's kMulti instances) and with H2 (kH2)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    B = batch or B_MAIN
    seed = 600
    fly_tal = ('Jout', 'Jmu', 'W_oor')
    t0 = time.time()
    big = amr_leaves('sphere3M')
    log(2, f'AMR: {len(big["x"])} leaves of make_amr_sphere({AMR_BIG}, 1) '
           f'in {time.time() - t0:.1f} s')
    jelly, gaps = amr_leaves('jellyfish'), amr_leaves('gaps')
    cases = (
        ('sphere3M', 'the 3.06M-leaf sphere, fine map, tau 1e7 with local '
         'core-skip, one observer', AMR_SPHERE, big,
         dict(core_skip=True, taumax=1e7, **OBSERVER),
         ('fly', 'refill', 'scatter', 'direct', 'resonance')),
        ('sphere3M descent', 'the 3.06M-leaf sphere, octant descent, one '
         'observer', AMR_SPHERE, big,
         dict(amr_fine_lookup_max=0, **OBSERVER),
         ('fly', 'refill', 'resonance')),
        ('jellyfish', 'jellyfish_pt as written: 8e3 / 3e5 K, vy, dust, '
         'core-skip, its observer', JELLY, jelly, {},
         ('fly', 'refill', 'scatter', 'direct', 'resonance', 'dust')),
        ('jellyfish descent', 'jellyfish_pt, octant descent', JELLY, jelly,
         dict(amr_fine_lookup_max=0), ('fly', 'scatter', 'resonance')),
        ('sphere48k gaps Mg II', 'the 48k sphere with 5% gap cells, Mg II '
         '2796 (kMulti)', AMR_SPHERE, gaps, MGII, ('fly', 'scatter')),
        ('sphere48k gaps H2', 'the 48k sphere with 5% gap cells, H2 f_H2 '
         '0.03 (kH2)', AMR_SPHERE, gaps,
         dict(h2_model='neufeld', f_H2=0.03, h2_temperature=8000.0),
         ('fly', 'scatter')))
    for label, what, rel, leaves, over, steps in cases:
        par = example_params(rel, batch_size=B, **over)
        meta, ch, t_build, builder = amr_chunk(par, leaves, dev)
        amr = ch.flight.amr
        assert builder == 'native', builder
        lt = ch.scatter_params.line.line_type
        key = AMR if lt == 1 and not ch.h2 else AMR + (H2 if ch.h2 else LINES)
        log(2, f'AMR {label} ({what}): {meta.nx} nodes, levelmax '
               f'{meta.levelmax}, fine map {amr.nf}^3, uniform T '
               f'{meta.uniform_temperature}, static {meta.static_medium}, '
               f'dust {meta.has_dust}; built by the {builder} octree '
               f'builder in {t_build:.1f} s')

        def state(sd, phases=(0, 1, 2, 3)):
            return testing.amr_state(meta, amr, B, sd, dev, phases=phases)
        for step in steps:
            seed += 2
            if step == 'fly':
                s0 = state(seed)
                gap = int((amr.leaf(s0.ic) < 0).sum())
                _, sk, frac, err, tal = both(meta, seed, fly_step(ch),
                                             fly_tal, dev, nmu=ch.nmu,
                                             state=s0, h2=ch.h2)
                moved = int((sk.ic != s0.ic).sum())
                _max_err(res, 'fly_amr', err)
                log(2, f'  K8 fly_amr ({"kH2" if ch.h2 else "kMulti" if lt != 1 else "line type 1"}): '
                       f'{gap} lanes start in gap cells, {moved} change '
                       f'node; lanes differing {frac:.2e}, max abs err '
                       f'{err:.3e}; tallies max |d| {tal}')
            elif step == 'refill':
                s0 = state(seed)
                _, sk, frac, err, tal = both(meta, seed, refill_step(ch),
                                             ('Jin',), dev, state=s0)
                born = (s0.phase == 0) & (sk.phase != 0)
                src = amr.find_cell(*(torch.full((1,), v, device=dev)
                                      for v in (ch.refill_params.xs,
                                                ch.refill_params.ys,
                                                ch.refill_params.zs)))
                assert bool((sk.ic[born] == src).all())
                _max_err(res, 'refill_point' + AMR, err)
                log(2, f'  K2 refill_point (AMR birth node {int(src)}): '
                       f'{int(born.sum())} births; lanes differing '
                       f'{frac:.2e}, max abs err {err:.3e}; Jin max |d| '
                       f'{tal["Jin"]:.3e}')
            elif step == 'scatter':
                s0 = state(seed, phases=(3,))
                recs = {}
                tals = ('nscatt_gas', 'nscatt_events') + (
                    ('Jabs', 'nscatt_dust') if ch.scatter_params.dust
                    else ()) + (('W_H2abs', 'W_H2scat', 'W_H2pump')
                                if ch.h2 else ())
                _, sk, frac, err, tal = both(
                    meta, seed, scatter_step(ch, recs=recs if ch.peel
                                             else None), tals, dev,
                    state=s0, h2=ch.h2)
                sp = ch.scatter_params
                core = ''
                if sp.core_skip:
                    core = f', {_in_core_fraction(s0, sp):.4f} in the core'
                n_rec, rerr = record_diff(recs[True], recs[False]) \
                    if recs else (0, 0.0)
                assert n_rec <= MAX_FRAC * B, n_rec
                _max_err(res, 'scatter_lya' + key, max(err, rerr))
                log(2, f'  K4 scatter_lya (AMR gathers{core}): '
                       f'{int((sk.phase == 0).sum())} of {B} lanes dead '
                       f'after; lanes differing {frac:.2e}, max abs err '
                       f'{err:.3e}; record lanes differing {n_rec}; '
                       f'tallies max |d| {tal}')
            else:
                mode = {'direct': tpeel.DIRECT,
                        'resonance': tpeel.RESONANCE,
                        'dust': tpeel.DUST}[step]
                n_bad, n_dep, err, dtau, dw = peel_both(
                    ch, meta, seed, mode, dev, state_fn=state)
                _max_err(res, 'peel' + AMR, err)
                log(2, f'  K7 peel {step} (AMR sightline, '
                       f'{ch.peel.obs_meta.nxim}x{ch.peel.obs_meta.nyim} x '
                       f'{meta.nxfreq} bins): {n_dep} of {B_MAIN} pairs '
                       f'deposit, pairs differing {n_bad}, max |d tau| '
                       f'{dtau:.3e}, per-pair deposits max rel err {dw:.3e}'
                       f', cubes max abs err {err:.3e}')
        del ch
    del big


def amr_phase3(dev):
    """driver.run on cuda and on cpu of a 16-base AMR sphere (tau 20, 1e4
    photons) and of the jellyfish_pt grid cut to taumax 10 and 8000
    photons, its dust raised 1e8-fold (a dust tau ~0.3; the moving,
    non-uniform-temperature medium, core-skip, a 21 x 21 observer): the
    statistical gates of ROADMAP, and the weight closure with the dust's
    absorption.  A jellyfish_pt photon's scatterings spread widely (disk or
    halo), so <N> needs these photons for the 5% gate to stand well beyond
    the spread of two runs."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.amr import make_amr_sphere
    need = ('refill_point', 'fly_amr', 'scatter_lya')
    c = spectra_run('AMR sphere make_amr_sphere(16, 1) tau0 20 1e4 photons',
                    testing.amr_params(16, 1, tau0=20.0, nphotons=10_000,
                                       batch=4096), dev,
                    amr_data=make_amr_sphere(16, 1))
    assert all(c.get(k) for k in need), c
    par = example_params(JELLY, taumax=10.0, nphotons=8000, batch_size=4096,
                         nxim=21, nyim=21, dxim=0.15, dyim=0.15,
                         distance=100.0, cext_dust=1.6e-13,
                         xfreq_min=-80.0, xfreq_max=80.0, nxfreq=320)
    n = par.nphotons
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev, amr_leaves('jellyfish'))
    for r in (rg, rc):
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (r.W_escape, r.W_absorb, r.W_oor)
        assert float(r.peel['scatt'].sum()) > 0.0
    p = 0.5 * (rg.W_absorb + rc.W_absorb)
    assert abs(rg.W_absorb - rc.W_absorb) <= 3 * np.sqrt(2 * p * (1 - p) / n)
    assert abs(rg.nscatt_gas / rc.nscatt_gas - 1.0) < 0.05
    chi2, nb = testing.spectra_chi2(rg.Jout, rc.Jout, n * rg.W_escape,
                                    n * rc.W_escape)
    assert chi2 < 3.0, chi2
    assert all(counts.get(k) for k in need + ('peel',)), counts
    log(3, f'jellyfish_pt (taumax 10, {n} photons, its observer): W_esc + '
           f'W_abs + W_oor cuda {rg.W_escape:.6f} + {rg.W_absorb:.6f} + '
           f'{rg.W_oor:.6f} ({tg:.1f} s), cpu {rc.W_escape:.6f} + '
           f'{rc.W_absorb:.6f} + {rc.W_oor:.6f} ({tc:.1f} s); <N> '
           f'{rg.nscatt_gas:.3f} / {rc.nscatt_gas:.3f}; Jout chi2/dof '
           f'{chi2:.2f} over {nb} bins; launches {counts}')


def amr_runs(tmp, device, total):
    """The slice's examples through driver.run with the leaves in memory
    (amr_data: the card's machine has no h5py), FITS written and read back:
    examples/amr_sphere/amr_sphere.in as written (its leaves are
    make_amr_sphere(32, 1)) with the all-photons table (allph_check); its
    Cartesian twin, the same sphere on a 64^3
    grid, for the AMR-vs-Cartesian <N_scatt> ratio (the reference recorded
    0.985); jellyfish_pt.in with taumax cut to JELLY_TAU, its observer's
    _peel3D file.  Launch counts go into total['amr']."""
    from lart_tpu_torch import driver
    from lart_tpu_torch.io.writer import read_spectrum, write_output
    from lart_tpu_torch.kernels import build as kb

    def run(label, par, leaves, need):
        out = Path(tmp) / (label + '.fits')
        par.file_format, par.out_file = 'fits', str(out)
        table = par.save_all_photons
        kb.reset_launch_counts()
        t0 = time.time()
        r = driver.run(par, device=device, amr_data=leaves)
        torch.cuda.synchronize()
        wall = time.time() - t0
        write_output(par.out_file, r)
        spec = read_spectrum(str(out))
        launches = dict(kb.LAUNCHES)
        add_launches(total, launches, need)
        if table:
            # the table's checks; its launches (K8's kAllph instance) go
            # into total['allph'], not total['amr']
            allph_check(label, r, out, wall, launches, total, 'fly_amr')
        if leaves is not None and not table:
            sub = total.setdefault('amr', {})
            for k, v in launches.items():
                sub[k] = sub.get(k, 0) + v
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == r.xfreq.shape
        assert float(spec['W_esc']) == r.W_escape
        w = r.W_escape + r.W_absorb + r.W_oor
        assert abs(w - 1.0) < 1e-3, (r.W_escape, r.W_absorb, r.W_oor)
        log(4, f'{label}: {r.nphotons} photons, W_esc {r.W_escape:.6f} + '
               f'W_abs {r.W_absorb:.6f} + W_oor {r.W_oor:.6f} = {w:.6f}, '
               f'<N_scatt> {r.nscatt_gas:.2f}, wall {wall:.1f} s; launches '
               f'{launches}')
        return r

    need = ('refill_point', 'fly_amr', 'scatter_lya')
    # with the all-photons table (testing.SOURCE_CASES['amr_sphere_allph'])
    ra = run('amr_sphere', example_params(AMR_SPHERE, save_all_photons=True),
             amr_leaves('sphere48k'), need)
    rc = run('amr_sphere_cartesian_twin', example_params(
        AMR_SPHERE, use_amr_grid=False, rmax=1.0, nx=64, ny=64, nz=64,
        xmax=1.0, ymax=1.0, zmax=1.0), None,
        ('refill_point', 'scatter_lya'))
    ratio = ra.nscatt_gas / rc.nscatt_gas
    assert abs(ratio - 1.0) < 0.05, ratio
    log(4, f'AMR-vs-Cartesian <N_scatt> ratio {ratio:.4f} (AMR '
           f'{ra.nscatt_gas:.2f}, Cartesian 64^3 {rc.nscatt_gas:.2f})')
    rj = run('jellyfish_pt', example_params(JELLY, taumax=JELLY_TAU),
             amr_leaves('jellyfish'), need + ('peel',))
    om = rj.obs_meta
    from lart_tpu_torch.io.iofile import open_read
    with open_read(str(Path(tmp) / 'jellyfish_pt_peel3D.fits')) as f:
        cube = np.asarray(f['Scattered/data'])
    assert cube.shape == (rj.meta.nxfreq, om.nxim, om.nyim) and cube.sum() > 0
    log(4, f'jellyfish_pt (taumax {JELLY_TAU:g} of tau_pole 2.9e7 as '
           f'written): _peel3D scatt cube {cube.shape}, sum {cube.sum():.4e}')


def amr_phase5(dev, res):
    """Steady-state windows of the AMR cells with their profiles and kernel
    times: amr_sphere.in as written, the 3.06M-leaf sphere with its fine
    map and with the octant descent, jellyfish_pt as written with its
    observer.  K8's numbers come from the 3.06M-leaf sphere's fine map, the
    AMR branches of K2, K4 and K7 from jellyfish_pt."""
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    big = amr_leaves('sphere3M')
    names = ('refill_point', 'fly_amr', 'scatter_lya')
    cells = (
        ('amr_sphere (48000 leaves, levels 5-6, 64^3 fine map, tau 1e4)',
         'amr_sphere', example_params(AMR_SPHERE, **over),
         amr_leaves('sphere48k'), names, (), ''),
        ('sphere3M (3058784 leaves, levels 7-8, 256^3 fine map, tau 1e4)',
         'sphere3M', example_params(AMR_SPHERE, **over), big, names,
         ('fly_amr',), ''),
        ('sphere3M_descent (the same, octant descent)', 'sphere3M_descent',
         example_params(AMR_SPHERE, amr_fine_lookup_max=0, **over), big,
         names, (), ''),
        ('jellyfish_pt (4432 leaves, 8e3 / 3e5 K, vy, dust, core-skip, '
         '101x101 x 121 cube)', 'jellyfish', example_params(JELLY, **over),
         amr_leaves('jellyfish'), names + ('peel',),
         ('refill_point', 'scatter_lya', 'peel'), AMR))
    for label, key, cpar, leaves, kn, record, suffix in cells:
        p, _ = rate_window(label, cpar, dev, amr_data=leaves)
        card = smi()
        profile_chunks(p, card, key)
        kernel_times(p, card, key, res, kn, record=record, suffix=suffix)
        del p


# --------------------------------------------------------------------------
# the clump backend: K9 fly_clump_dense, K10 fly_clump_csr and the clump
# branches of K2, K4 and K7
# --------------------------------------------------------------------------

def clump_params(name, **over):
    """The Params of a clump population of this slice: 'overlap' is
    examples/clump_sphere/clumps_overlap.in as written (195 overlapping
    clumps: K9), 'bicone' examples/bicone/bicone_clump.in (6837 clumps: K10
    in non-overlap mode; save_clump_info off, as the card has no h5py),
    'fcov1' the 1,477,378-clump sphere at the scale of the reference's
    clump_fcov1 run (FCOV1: K10 far beyond the L2), 'sphere40' the 40-clump
    sphere of testing.clump_params."""
    from lart_tpu_torch import testing
    if name == 'overlap':
        return example_params(CLUMPS_OVERLAP, **over)
    if name == 'bicone':
        return example_params(BICONE, **{'save_clump_info': False, **over})
    if name == 'fcov1':
        return testing.clump_params(**{**FCOV1, **over})
    return testing.clump_params(**over)


def clump_chunk(par, dev):
    """(meta, chunk, build seconds) of par's clump population, built from
    the drivers' seed iseed + 77 on dev."""
    from lart_tpu_torch.grid.clump import build_clumps
    from lart_tpu_torch.transport.engine import make_chunk
    cfg = par.resolve()
    t0 = time.time()
    meta, cmeta, grid = build_clumps(cfg, seed=cfg.par.iseed + 77, device=dev)
    return meta, make_chunk(cfg, meta, grid, cmeta), time.time() - t0


def phase2_clump(dev, res, batch=None):
    """The clump backend: K9 and K10 in every mode and the clump branches
    of K2, K4 and K7 against their plain versions at B = batch (B_MAIN),
    lane by lane or pair by pair, from mixed clump states (lanes in the
    vacuum, inside clumps and within two nudges of a clump's surface, in
    every phase; testing.clump_state).  The populations: clumps_overlap.in
    as written (K9 in overlap mode, K2's dense clump_find, K4's dense owner
    draw, K7's clump sightline with an observer on +z), its population in
    non-overlap mode (owner_at), with clump_sigma_v 30 km/s, clump
    temperature 9e4 K, dust and Stokes (K4's frame shift and Jabs, the peel
    record, K7's dust peel), in the Mg II doublet (the kMulti instances),
    and through the CSR walker (clump_dense_max 0: K10's overlap form, K2's
    CSR clump_find, K4's CSR owner draw); bicone_clump.in (K10 in
    non-overlap mode, K7 on 6837 clumps); the 1.48M-clump population (K10
    beyond the L2); 1000 overlapping clumps (MANY_CHORDS: K9's second path,
    F recomputed from every clump, on the rays that cross more than its
    list of chords)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.fly_clump import CHORDS, crossed_chords
    B = batch or B_MAIN
    seed = 700
    fly_tal = ('Jout', 'Jmu', 'W_oor')
    hot = dict(clump_sigma_v=30.0, clump_temperature=9e4, DGR=3e-3,
               use_stokes=True, **OBSERVER)
    cases = (
        ('overlap', 'clumps_overlap.in as written, one observer (K9 '
         'overlap)', clump_params('overlap', **OBSERVER),
         ('fly', 'refill', 'scatter', 'direct', 'resonance')),
        ('overlap non-overlap', 'its population walked in non-overlap mode '
         '(owner_at)', clump_params('overlap', clump_allow_overlap=False),
         ('fly', 'scatter')),
        ('overlap hot', 'clumps_overlap.in with clump_sigma_v 30, '
         'clump_temperature 9e4, DGR 3e-3, Stokes, one observer',
         clump_params('overlap', **hot),
         ('fly', 'scatter', 'resonance', 'dust')),
        ('overlap Mg II', 'clumps_overlap.in in Mg II 2796 (kMulti)',
         clump_params('overlap', **MGII), ('fly', 'scatter')),
        ('overlap CSR', 'clumps_overlap.in through the CSR walker '
         '(clump_dense_max 0: K10 overlap form)',
         clump_params('overlap', clump_dense_max=0),
         ('fly', 'refill', 'scatter')),
        ('overlap CSR hot', 'the CSR walker with clump_sigma_v 30, '
         'clump_temperature 9e4', clump_params(
             'overlap', clump_dense_max=0, clump_sigma_v=30.0,
             clump_temperature=9e4), ('fly', 'scatter')),
        ('bicone', 'bicone_clump.in as written, one observer (K10 '
         'non-overlap)', clump_params('bicone', **OBSERVER),
         ('fly', 'refill', 'scatter', 'direct', 'resonance')),
        ('bicone Mg II', 'bicone_clump.in in Mg II 2796 (kMulti)',
         clump_params('bicone', **MGII), ('fly',)),
        ('fcov1', 'the 1.48M-clump population (K10 beyond the L2)',
         clump_params('fcov1'), ('fly', 'refill')),
        ('many chords', '1000 overlapping clumps of radius 0.2 (f_cov 30): '
         f'rays crossing more than K9\'s {CHORDS}-chord list',
         clump_params('sphere40', **MANY_CHORDS), ('fly',)))
    for label, what, par, steps in cases:
        par.batch_size = B
        meta, ch, t_build = clump_chunk(par, dev)
        cl = ch.flight.clump
        lt = ch.scatter_params.line.line_type
        multi = '' if lt == 1 else LINES
        fly_name = 'fly_clump_dense' if cl.dense else 'fly_clump_csr'
        log(2, f'clumps {label} ({what}): {cl.n} clumps, CSR {cl.cg_n}^3 x '
               f'K {cl.K}, dense {cl.dense}, overlap {cl.overlap}, static '
               f'{not cl.moving}, r_loc {cl.r_loc:.6f}, dust {cl.has_dust}; '
               f'built in {t_build:.1f} s')

        def state(sd, phases=(0, 1, 2, 3)):
            return testing.clump_state(meta, cl, B, sd, dev, phases=phases)
        for step in steps:
            seed += 2
            if step == 'fly':
                s0 = state(seed)
                inside = int((s0.ic >= 0).sum())
                # the lanes whose rays cross more chords than K9's list
                # holds: K9 recomputes their F from every clump
                n_over = int((crossed_chords(ch.flight, s0) > CHORDS).sum()) \
                    if cl.dense else 0
                assert n_over > 0.3 * B or label != 'many chords', n_over
                _, sk, frac, err, tal = both(meta, seed, fly_step(ch),
                                             fly_tal, dev, nmu=ch.nmu,
                                             state=s0)
                _max_err(res, fly_name + multi, err)
                log(2, f'  {"K9" if cl.dense else "K10"} {fly_name} '
                       f'({"kMulti" if multi else "line type 1"}): {inside} '
                       f'lanes start in a clump, {n_over} cross more than '
                       f'{CHORDS} chords, '
                       f'{int((sk.phase == 3).sum())} at a scattering after; '
                       f'lanes differing {frac:.2e}, max abs err {err:.3e}; '
                       f'tallies max |d| {tal}')
            elif step == 'refill':
                s0 = state(seed)
                _, sk, frac, err, tal = both(meta, seed, refill_step(ch),
                                             ('Jin',), dev, state=s0)
                born = (s0.phase == 0) & (sk.phase != 0)
                rp = ch.refill_params
                src = int(cl.find(*(torch.full((1,), v, device=dev)
                                    for v in (rp.xs, rp.ys, rp.zs))))
                assert bool((sk.ic[born] == src).all())
                _max_err(res, 'refill_point' + CLUMP, err)
                log(2, f'  K2 refill_point (birth clump {src}, '
                       f'{"dense" if cl.dense else "CSR"} clump_find): '
                       f'{int(born.sum())} births; lanes differing '
                       f'{frac:.2e}, max abs err {err:.3e}; Jin max |d| '
                       f'{tal["Jin"]:.3e}')
                # the source moved to clump 7's centre: births in a clump
                c7 = [float(v[7]) for v in (cl.dev.x, cl.dev.y, cl.dev.z)]
                ch7 = dataclasses.replace(ch, refill_params=dataclasses.replace(
                    rp, xs=c7[0], ys=c7[1], zs=c7[2]))
                _, sk, frac, err, tal = both(meta, seed, refill_step(ch7),
                                             ('Jin',), dev, state=s0)
                born = (s0.phase == 0) & (sk.phase != 0)
                assert bool((sk.ic[born] == 7).all()) or cl.overlap
                assert bool((sk.ic[born] >= 0).all())
                _max_err(res, 'refill_point' + CLUMP, err)
                log(2, f'  K2 refill_point, the source at clump 7\'s centre: '
                       f'{int(born.sum())} births in clump '
                       f'{int(sk.ic[born][0])}; lanes differing {frac:.2e}, '
                       f'max abs err {err:.3e}')
            elif step == 'scatter':
                s0 = state(seed, phases=(3,))
                recs = {}
                sp = ch.scatter_params
                tals = ('nscatt_gas', 'nscatt_events') + (
                    ('Jabs', 'nscatt_dust') if sp.dust else ())
                _, sk, frac, err, tal = both(
                    meta, seed, scatter_step(ch, recs=recs if ch.peel
                                             else None), tals, dev,
                    state=s0)
                n_rec, rerr = record_diff(recs[True], recs[False],
                                          dust_xatom=True) \
                    if recs else (0, 0.0)
                assert n_rec <= MAX_FRAC * B, n_rec
                owners = int((sk.ic != s0.ic).sum())
                _max_err(res, 'scatter_lya' + CLUMP + multi, max(err, rerr))
                log(2, f'  K4 scatter_lya (clump owner '
                       f'{"draw" if cl.overlap else "from the flight"}: '
                       f'{owners} lanes changed clump; frame shift '
                       f'{cl.shift}, dust {bool(sp.dust)}, Stokes '
                       f'{sp.stokes}): {int((sk.phase == 2).sum())} of {B} '
                       f'lanes scattered; lanes differing {frac:.2e}, max '
                       f'abs err {err:.3e}; record lanes differing {n_rec}; '
                       f'tallies max |d| {tal}')
            else:
                mode = {'direct': tpeel.DIRECT,
                        'resonance': tpeel.RESONANCE,
                        'dust': tpeel.DUST}[step]
                n_bad, n_dep, err, dtau, dw = peel_both(
                    ch, meta, seed, mode, dev, state_fn=state)
                _max_err(res, 'peel' + CLUMP, err)
                log(2, f'  K7 peel {step} (clump sightline, '
                       f'{ch.peel.max_steps} CSR cells at most, '
                       f'{ch.peel.obs_meta.nxim}x{ch.peel.obs_meta.nyim} x '
                       f'{meta.nxfreq} bins): {n_dep} of {B} pairs deposit, '
                       f'pairs differing {n_bad}, max |d tau| {dtau:.3e}, '
                       f'per-pair deposits max rel err {dw:.3e}, cubes max '
                       f'abs err {err:.3e}')
        del ch


def clump_phase3(dev):
    """driver.run on cuda and on cpu of the 40-clump sphere
    (testing.clump_params, 2e4 photons, Jmu on) in its dense form (K9,
    overlap mode: the owner draw) and its CSR form (K10, non-overlap):
    ROADMAP's statistical gates."""
    from lart_tpu_torch import testing
    for label, over, fly in (
            ('dense (K9, overlap)', dict(clump_allow_overlap=True),
             'fly_clump_dense'),
            ('CSR (K10, non-overlap)', dict(clump_dense_max=0),
             'fly_clump_csr')):
        par = testing.clump_params(nphotons=20_000, batch=4096,
                                   save_Jmu=True, nmu=8, **over)
        c = spectra_run(f'40-clump sphere {label}, 2e4 photons', par, dev)
        assert all(c.get(k) for k in ('refill_point', fly,
                                      'scatter_lya')), c


def clump_cli(tmp, device, total):
    """The slice's examples through the CLI, FITS written and read back:
    clumps_overlap.in as written (K9), the same population through the CSR
    walker (clump_dense_max 0: K10) with the <N_scatt> ratio K10 / K9,
    clumps_overlap.in with one observer on +z (K7's clump sightline; 2e4
    photons), and bicone_clump.in with save_clump_info off (K10 in
    non-overlap mode).  Each run's own launch counts go into
    total['clump'][label]."""
    from lart_tpu_torch.io.writer import read_spectrum

    def run(label, rel, need, **over):
        nml = namelist_variant(rel, tmp, **over)
        out = Path(tmp) / (label + '.fits')
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == res.xfreq.shape
        assert float(spec['W_esc']) == res.W_escape
        w = res.W_escape + res.W_absorb + res.W_oor
        assert abs(w - 1.0) < 1e-3, (res.W_escape, res.W_absorb, res.W_oor)
        add_launches(total, launches, need)
        total.setdefault('clump', {})[label] = dict(launches)
        log(4, f'CLI {label} ({res.nphotons} photons, FITS): W_esc '
               f'{res.W_escape:.6f} + W_oor {res.W_oor:.6f} = {w:.6f}, '
               f'<N_scatt> {res.nscatt_gas:.4f}, wall {wall:.1f} s; '
               f'launches {launches}')
        return res

    need = ('refill_point', 'scatter_lya')
    r9 = run('clumps_overlap', CLUMPS_OVERLAP, need + ('fly_clump_dense',))
    r10 = run('clumps_overlap_csr', CLUMPS_OVERLAP,
              need + ('fly_clump_csr',), clump_dense_max=0)
    ratio = r10.nscatt_gas / r9.nscatt_gas
    assert abs(ratio - 1.0) < 0.05, ratio
    log(4, f'clumps_overlap <N_scatt> K10 / K9 {ratio:.4f} (CSR '
           f'{r10.nscatt_gas:.4f}, dense {r9.nscatt_gas:.4f})')
    rp = run('clumps_overlap_peel', CLUMPS_OVERLAP,
             need + ('fly_clump_dense', 'peel'), nphotons='2e4',
             save_peeloff='.true.', nobs=1, distance='1e3',
             **{'alpha(1)': '0.0', 'beta(1)': '0.0'})
    om = rp.obs_meta
    from lart_tpu_torch.io.iofile import open_read
    with open_read(str(Path(tmp) / 'clumps_overlap_peel_peel3D.fits')) as f:
        cube = np.asarray(f['Scattered/data'])
    assert cube.shape == (rp.meta.nxfreq, om.nxim, om.nyim) and cube.sum() > 0
    run('bicone_clump', BICONE, need + ('fly_clump_csr',),
        save_clump_info='.false.')


def clump_phase5(dev, res):
    """Steady-state windows of the clump cells with their profiles and
    kernel times: clumps_overlap.in as written (K9; K2's and K4's clump
    branches), bicone_clump.in (K10 non-overlap), the 1.48M-clump
    population (K10 beyond the L2, its row of the kernel table) and
    clumps_overlap.in with one observer on +z (K7's clump sightline)."""
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    names = ('refill_point', 'scatter_lya')
    cells = (
        ('clumps_overlap (195 overlapping clumps, tau0 10, K9)', 'overlap',
         clump_params('overlap', **over), names + ('fly_clump_dense',),
         ('fly_clump_dense', ('refill_point', CLUMP),
          ('scatter_lya', CLUMP))),
        ('bicone_clump (6837 clumps, tau0 1e3, K10 non-overlap)', 'bicone',
         clump_params('bicone', **over), names + ('fly_clump_csr',), ()),
        ('fcov1 (1477378 clumps, N_HI 1e18, K10 non-overlap)', 'fcov1',
         clump_params('fcov1', **over), names + ('fly_clump_csr',),
         ('fly_clump_csr',)),
        ('clumps_overlap_peel (the same, one observer on +z)',
         'overlap_peel', clump_params('overlap', **over, **OBSERVER),
         names + ('fly_clump_dense', 'peel'), (('peel', CLUMP),)))
    for label, key, cpar, kn, record in cells:
        p, _ = rate_window(label, cpar, dev)
        card = smi()
        profile_chunks(p, card, key)
        kernel_times(p, card, key, res, kn, record=record)
        del p


def civ_params(**over):
    """examples/healpix_CIV/CIV_test.in with save_peeloff on (as written it
    sets none, so lart_tpu writes neither maps nor tau files for it) and
    the keys of `over` replaced."""
    return example_params(CIV, save_peeloff=True, **over)


def sightline_both(sl):
    """K11 and its plain version on the card, every (observer, column,
    pixel) ray: (rays differing, rays, max abs err of the optical-depth
    columns over the others, max rel err of the N_gas column, the plain
    version's work stats)."""
    from lart_tpu_torch.instruments import sightline as tsl
    k = tsl.sightline(sl)
    torch.cuda.synchronize()
    stats = {}
    p = tsl.sightline_plain(sl, stats)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(k).all()) and float(p.max()) > 0.0
    bad = ~torch.isclose(k, p, rtol=LANE_RTOL, atol=LANE_ATOL)
    n_bad = int(bad.sum())
    good = ~bad
    tau = good[:, 1:]
    err = float((k[:, 1:] - p[:, 1:]).abs()[tau].max()) if bool(
        tau.any()) else 0.0
    ng = good[:, 0]
    rel = float(((k[:, 0] - p[:, 0]).abs() / p[:, 0].abs().clamp_min(1e-30))
                [ng].max()) if bool(ng.any()) else 0.0
    assert n_bad <= MAX_FRAC * k.numel(), (n_bad, k.numel())
    return n_bad, k.numel(), err, rel, stats


def phase2_inside(dev, res):
    """The interior all-sky observer, the sight-line maps and the
    exponential-cylinder source against their plain versions at B =
    B_MAIN: K7's interior mode (HEALPix pixel, capped sightline) on
    CIV_test's 101x101x51 grid (the DDA, line type 2), on the sphere_peel
    grid (the chord) and the 48k-leaf AMR sphere (the node walk), and on
    the dusty DL20e_dust shell (Henyey-Greenstein dust peel); K11 on
    CIV_test's whole nside-64 map (49152 pixels x 123 columns, 6.05M rays),
    on sightline_car.in as written (65x65 TAN), on the 201^3 Hubble grid of
    vel_effect_peel (TAN and interior: the comoving updates), on the 48k
    AMR sphere (TAN), on clumps_overlap.in and on the 1.48M-clump
    population (TAN); K2's exponential-cylinder births on CIV_test's grid,
    on that Hubble grid (each birth's cell velocity) and on the AMR
    sphere."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.instruments.sightline import Sightline
    from lart_tpu_torch.transport.engine import make_chunk
    modes = {'direct': tpeel.DIRECT, 'resonance': tpeel.RESONANCE,
             'dust': tpeel.DUST}
    inner = dict(obsx=(0.3,), obsy=(0.1,), obsz=(-0.2,), nside=64)
    expcyl = dict(source_geometry='exponential_cylinder', source_rscale=0.3,
                  source_zscale=0.2)
    seed = 900

    def cart(par):
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        return cfg, meta, grid, make_chunk(cfg, meta, grid)

    def peel_cases(label, meta, ch, steps, r_max=None, state_fn=None):
        nonlocal seed
        om = ch.peel.obs_meta
        assert om.inside and om.nxim == om.npix and om.nyim == 1
        for step in steps:
            seed += 2
            n_bad, n_dep, err, dtau, dw = peel_both(
                ch, meta, seed, modes[step], dev, r_max, state_fn=state_fn)
            _max_err(res, 'peel' + INSIDE, err)
            log(2, f'K7 peel {step}, interior observer at '
                   f'{tuple(float(v) for v in om.pos_host[0])}, {label} '
                   f'(nside {om.nside}, {om.npix} pixels x {meta.nxfreq} '
                   f'bins): {n_dep} of {B_MAIN} pairs deposit, pairs '
                   f'differing {n_bad}, max |d tau| {dtau:.3e}, per-pair '
                   f'deposits max rel err {dw:.3e}, cubes max abs err '
                   f'{err:.3e}')

    def sightline_case(label, cfg, meta, grid, cmeta=None):
        t0 = time.time()
        sl = Sightline.from_config(cfg, meta, grid, cmeta)
        n_bad, n, err, rel, st = sightline_both(sl)
        _max_err(res, 'sightline', err)
        om = sl.obs_meta
        rays = f'HEALPix nside {om.nside}' if om.inside \
            else f'TAN {om.nxim}x{om.nyim}'
        log(2, f'K11 sightline, {label} ({rays}, '
               f'{sl.ncol} columns, {n} rays, {st["rays"]} in the box, '
               f'{st["gas"] + st["col"]} crossings over {st["cells"]} '
               f'distinct cells): rays differing {n_bad}, max abs err '
               f'{err:.3e} (tau), N_gas max rel err {rel:.3e} '
               f'({time.time() - t0:.1f} s)')

    # CIV_test, the slice's main path: K7 interior (DDA), K11's whole map,
    # K2's births
    t0 = time.time()
    cfg, meta, grid, ch = cart(civ_params(batch_size=B_MAIN))
    log(2, f'CIV_test.in with save_peeloff: {meta.nx}x{meta.ny}x{meta.nz} '
           f'grid, line type {cfg.line.line_type}, {meta.nxfreq} bins, '
           f'source {cfg.par.source_geometry}, built in '
           f'{time.time() - t0:.1f} s')
    peel_cases('CIV_test (101x101x51 DDA, C IV doublet)', meta, ch,
               ('direct', 'resonance'))
    seed += 2
    peel_packed('CIV_test, interior, resonance', ch, meta, seed,
                tpeel.RESONANCE, dev, res)
    sightline_case('CIV_test as written', cfg, meta, grid)
    s0, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',),
                                  dev)
    born = (s0.phase == 0) & (sk.phase != 0)
    _max_err(res, 'refill_radial' + EXPCYL, err)
    log(2, f'K2 refill_radial (exponential_cylinder, rscale '
           f'{cfg.par.source_rscale}, zscale {cfg.par.source_zscale}, table '
           f'{ch.refill_params.source.table.n} knots): {int(born.sum())} '
           f'births, birth radius max '
           f'{float(torch.hypot(sk.bx, sk.by)[born].max()):.4f}, |z| max '
           f'{float(sk.bz[born].abs().max()):.4f}; lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}; Jin max |d| '
           f'{tal["Jin"]:.3e}')
    del ch, grid

    # the chord and the dusty shell
    cfg, meta, grid, ch = cart(example_params(
        PEEL_EXAMPLES['sphere_peel'], use_stokes=False, batch_size=B_MAIN,
        **inner))
    assert ch.peel.chord
    peel_cases('sphere_peel grid (the chord)', meta, ch,
               ('direct', 'resonance'), r_max=1.0)
    cfg, meta, grid, ch = cart(example_params(
        DL20E_DUST, use_stokes=False, save_peeloff=True, batch_size=B_MAIN,
        **inner))
    assert ch.peel.dust
    peel_cases('DL20e_dust grid (201^3 dusty shell, Henyey-Greenstein)',
               meta, ch, ('direct', 'resonance', 'dust'), r_max=1.0)
    del ch, grid

    # sightline_car.in as written
    par = example_params(SL_CAR, save_peeloff=True)
    cfg = par.resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    sightline_case('sightline_car.in as written', cfg, meta, grid)

    # the 201^3 Hubble grid: K11 TAN and interior, K2's births with each
    # cell's velocity
    for label, over in (('TAN', {}), ('interior', dict(
            inner, nside=16))):
        par = example_params(PEEL_EXAMPLES['vel_effect_peel'], nxfreq=21,
                             **over)
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        sightline_case(f'vel_effect_peel 201^3 Hubble grid, {label}', cfg,
                       meta, grid)
    cfg, meta, grid, ch = cart(example_params(
        PEEL_EXAMPLES['vel_effect_peel'], batch_size=B_MAIN,
        comoving_source=False, **expcyl))
    assert ch.refill_params.vel is not None
    seed += 2
    _, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',), dev,
                                 r_max=1.0)
    _max_err(res, 'refill_radial' + EXPCYL, err)
    log(2, f'K2 refill_radial (exponential_cylinder on the Hubble grid, '
           f'lab-frame source): lanes differing {frac:.2e}, max abs err '
           f'{err:.3e}; Jin max |d| {tal["Jin"]:.3e}')
    del ch, grid

    # the 48k-leaf AMR sphere: K7 interior, K11 TAN, K2's births
    amr_inner = dict(inner, obsx=(0.2,), obsy=(0.1,), obsz=(-0.1,))
    data = amr_leaves('sphere48k')
    meta, ch, _, _ = amr_chunk(example_params(
        AMR_SPHERE, batch_size=B_MAIN, save_peeloff=True, **amr_inner),
        data, dev)

    def amr_state(sd):
        return testing.amr_state(meta, ch.flight.amr, B_MAIN, sd, dev)
    peel_cases('amr_sphere (48k leaves, the node walk)', meta, ch,
               ('direct', 'resonance'), state_fn=amr_state)
    from lart_tpu_torch.grid.amr import build_amr
    par = example_params(AMR_SPHERE, nxfreq=21, **OBSERVER)
    cfg = par.resolve()
    r = build_amr(cfg, data=data, device=dev)
    sightline_case('amr_sphere (48k leaves)', cfg, r.meta, r.dev)
    meta, ch, _, _ = amr_chunk(example_params(
        AMR_SPHERE, batch_size=B_MAIN, **expcyl), data, dev)
    seed += 2
    _, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',), dev,
                                 state=amr_state(seed))
    _max_err(res, 'refill_radial' + EXPCYL, err)
    log(2, f'K2 refill_radial (exponential_cylinder on the AMR sphere: each '
           f'birth finds its node): lanes differing {frac:.2e}, max abs err '
           f'{err:.3e}; Jin max |d| {tal["Jin"]:.3e}')
    del ch, r, data

    # clumps: clumps_overlap.in and the 1.48M-clump population, TAN
    from lart_tpu_torch.grid.clump import build_clumps
    for label, par in (('clumps_overlap.in', clump_params(
            'overlap', nxfreq=21, **OBSERVER)),
            # a 65 x 65 image: the plain CSR walk on 129 x 129 rays of 23
            # columns took ~20 s of the script's time limit
            ('the 1.48M-clump population', clump_params(
                'fcov1', nxfreq=21, **dict(OBSERVER, nxim=65, nyim=65)))):
        cfg = par.resolve()
        meta, cmeta, grid = build_clumps(cfg, seed=cfg.par.iseed + 77,
                                         device=dev)
        sightline_case(f'{label} ({cmeta.n_clumps} clumps)', cfg, meta,
                       grid, cmeta)
        del grid


def sources_chunk(par, dev, amr_data=None):
    """(cfg, meta, grid, chunk) of par on dev, its table source built from
    the grid's host data (driver.prepare's host_data): the Cartesian
    grid's rhokap, or the AMR leaves' emissivity column."""
    from lart_tpu_torch.grid.amr import build_amr
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.transport.engine import make_chunk
    cfg = par.resolve()
    hd = {}
    if amr_data is not None:
        built = build_amr(cfg, data=amr_data, device=dev)
        meta, grid = built.meta, built.dev
        hd['emissivity'] = built.emissivity
    else:
        meta, grid = build_cartesian(cfg, device=dev, host_out=hd)
    return cfg, meta, grid, make_chunk(cfg, meta, grid, host_data=hd)


def phase2_sources(dev, res):
    """The volume and table sources against their plain versions at B =
    B_MAIN, lane by lane, each K2 instance from a mixed state: the volume
    instance on t4tau2.in as written (uniform_sphere, continuum, He I),
    with voigt0 and continuum+gaussian, and a point source with voigt0;
    every analytic geometry on the 201^3 Hubble grid of
    vel_effect/t4NHI2_20_V0200.in (each birth's cell velocity, folded by
    xyz_symmetry); the radial instance on
    halo_0053.in as written (ssh, its velocity field) and with
    exponential_sphere and a sersic m = 4; the alias instance on
    stars1.in as written (composite weights), density1 and density2 on a
    65^3 cut of halo_0053's grid, the jellyfish AMR leaves' emissivity, the
    1-D profile of AlII_ex.in and density1 over 205^3 = 8.6M cells (a
    table beyond 2^23 bins).  Each instance's max abs err goes into res
    under its name."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.state import DEAD
    seed = 1100

    def case(label, cfg, meta, ch, state=None, weighted=False):
        nonlocal seed
        seed += 2
        rp = ch.refill_params
        s0, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',),
                                      dev, state=state)
        born = s0.phase == DEAD
        _max_err(res, rp.kernel, err)
        pos = torch.stack([sk.x[born], sk.y[born], sk.z[born]])
        assert bool(torch.isfinite(pos).all())
        box = torch.tensor([[meta.xmin], [meta.ymin], [meta.zmin]],
                           device=dev), torch.tensor(
            [[meta.xmax], [meta.ymax], [meta.zmax]], device=dev)
        inside = float(((pos >= box[0] - 1e-6) & (pos <= box[1] + 1e-6))
                       .all(0).float().mean())
        w = sk.wgt[born].double()
        if weighted:
            assert float(w.std()) > 0.0, 'composite weights all equal'
        log(2, f'K2 {rp.kernel} ({label}): {int(born.sum())} births, '
               f'{100 * inside:.2f}% inside the box, weight mean '
               f'{float(w.mean()):.6f} (min {float(w.min()):.4g}, max '
               f'{float(w.max()):.4g}); lanes differing {frac:.2e}, max abs err {err:.3e}; Jin max '
               f'|d| {tal["Jin"]:.3e}')

    # the volume instance: t4tau2.in as written and its spectra
    t4 = dict(batch_size=B_MAIN)
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        't4tau2', ROOT, **t4), dev)
    assert ch.refill_params.kernel == 'refill_volume'
    case('t4tau2.in as written: uniform_sphere, continuum, He I', cfg, meta,
         ch)
    for label, over in (
            ('t4tau2 with voigt0 at temperature0 3e4', dict(
                spectral_type='voigt0', temperature0=3e4)),
            ('t4tau2 with continuum+gaussian, EW_line 20', dict(
                spectral_type='continuum+gaussian', EW_line=20.0)),
            ('t4tau2 with a point source, voigt0', dict(
                spectral_type='voigt0', source_geometry='point'))):
        c2 = testing.source_params('t4tau2', ROOT, **t4, **over).resolve()
        case(label, c2, meta, make_chunk(c2, meta, grid))
    del ch, grid

    # every analytic geometry on the 201^3 Hubble grid
    hub = dict(batch_size=B_MAIN, comoving_source=False)
    cfg, meta, grid, ch = sources_chunk(example_params(
        VEL_EFFECT, source_geometry='uniform_sphere',
        **hub), dev)
    assert ch.refill_params.vel is not None and cfg.par.xyz_symmetry
    case('uniform_sphere on the Hubble grid', cfg, meta, ch)
    for sg, over in (('cylinder', {}), ('uniform', {}), ('uniform_xy', {}),
                     ('uniform_xy', dict(source_rmax=0.5)),
                     ('gaussian', dict(source_zscale=0.3)),
                     ('exponential', dict(source_zscale=0.3))):
        c2 = example_params(VEL_EFFECT,
                            source_geometry=sg, **hub, **over).resolve()
        case(f'{sg} {over or ""} on the Hubble grid', c2, meta,
             make_chunk(c2, meta, grid))
    del ch, grid

    # the radial instance: halo_0053.in as written (ssh), its grid with an
    # exponential sphere and a sersic m = 4
    cfg, meta, grid, ch = sources_chunk(example_params(
        'SSH_MUSE/halo_0053.in', batch_size=B_MAIN), dev)
    assert ch.refill_params.kernel == 'refill_radial'
    case(f'halo_0053.in as written: ssh, table '
         f'{ch.refill_params.source.table.n} knots', cfg, meta, ch)
    for sg, over in (('exponential_sphere', dict(source_rscale=0.2)),
                     ('sersic', dict(sersic_m=4.0, Reff=0.3))):
        c2 = example_params('SSH_MUSE/halo_0053.in', batch_size=B_MAIN,
                            source_geometry=sg, **over).resolve()
        case(f'{sg} on the halo_0053 grid', c2, meta,
             make_chunk(c2, meta, grid))
    del ch, grid

    # the alias instance
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        'stars1', ROOT, cut=False, batch_size=B_MAIN), dev)
    assert ch.refill_params.kernel == 'refill_alias'
    case(f'stars1.in as written: {ch.refill_params.source.tabs.nbin} stars,'
         f' composite weights', cfg, meta, ch, weighted=True)
    del ch, grid
    for emiss, method in (('density1', 1), ('density2', 0)):
        cfg, meta, grid, ch = sources_chunk(example_params(
            'SSH_MUSE/halo_0053.in', batch_size=B_MAIN, nx=65, ny=65, nz=65,
            source_geometry='diffuse_emissivity', emiss_file=emiss,
            sampling_method=method), dev)
        case(f'{emiss} on a 65^3 cut of the halo_0053 grid, '
             f'sampling_method {method}', cfg, meta, ch,
             weighted=method > 0)
    data = amr_leaves('jellyfish')
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        'jellyfish_emiss', ROOT, batch_size=B_MAIN), dev, data)
    case(f'jellyfish_emiss: {grid.leaf_cx.numel()} AMR leaves\' emissivity',
         cfg, meta, ch, state=testing.amr_state(
             meta, ch.flight.amr, B_MAIN, seed + 1, dev), weighted=True)
    del ch, grid, data
    t0 = time.time()
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        't4tau2', ROOT, batch_size=B_MAIN, nx=205, ny=205, nz=205,
        source_geometry='diffuse_emissivity', emiss_file='density1'), dev)
    nbin = ch.refill_params.source.tabs.nbin
    assert nbin > 2 ** 23
    case(f'density1 over 205^3 = {nbin} cells (set-up {time.time() - t0:.1f}'
         f' s)', cfg, meta, ch)
    del ch, grid


def cut_of(name):
    """The keys testing.SOURCE_CASES[name] replaces, as namelist_variant
    takes them."""
    from lart_tpu_torch import testing
    return {k: ('.true.' if v else '.false.') if isinstance(v, bool)
            else f'{v:g}' for k, v in testing.SOURCE_CASES[name][1].items()}


def source_variant(name, tmp, **over):
    """testing.SOURCE_CASES[name] rewritten into tmp (namelist_variant): its
    files made absolute, its cut and `over` applied."""
    from lart_tpu_torch import testing
    rel, cut = testing.SOURCE_CASES[name]
    keys = {**testing.source_files(ROOT / 'examples' / rel), **cut, **over}
    return namelist_variant(rel, tmp, **{
        k: f"'{v}'" if isinstance(v, str) else (
            ('.true.' if v else '.false.') if isinstance(v, bool)
            else f'{v:g}') for k, v in keys.items()})


# each source case's K2 instance and the rest of its path (phase 4)
SOURCE_PATHS = {
    't4tau2': ('refill_volume', 'fly_uniform_sphere', 'scatter_lya'),
    'un_tau100_coh': ('refill_volume', 'fly_uniform_sphere', 'scatter_lya',
                      'peel'),
    'stars1': ('refill_alias', 'fly_cartesian', 'scatter_lya', 'peel'),
    'halo_0053': ('refill_radial', 'fly_cartesian', 'scatter_lya', 'peel',
                  'sightline'),
    'jellyfish_emiss': ('refill_alias', 'fly_amr', 'scatter_lya', 'peel'),
}


def sources_cli(tmp, device, total):
    """The volume and table sources' examples, FITS written and read back:
    through the CLI t4tau2.in and un_tau100_coh.in as written, stars1.in
    cut to 2e4 photons and taumax 3e3, halo_0053.in cut to taumax 1e4
    (AlII_ex.in runs as written in temperature_cli); jellyfish_emiss.in cut
    to taumax 3e3 (xfreq +-80) through driver.run with its leaves in
    memory (the card's machine has no h5py) (testing.SOURCE_CASES).
    The weight budget W_esc + W_abs + W_oor against the birth weights'
    sum over the photons (1, or Jin's sum where a table's composite weights
    bias the births), <N_scatt> for PERF.md beside lart_tpu's CPU runs of
    the same cuts (tools/sources_cpu_runs.py).  Each run's launch counts go
    into total['sources'][name]."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum, write_output
    from lart_tpu_torch.kernels import build as kb
    sub = total.setdefault('sources', {})
    for name in SOURCE_PATHS:
        out = Path(tmp) / (name + '.fits')
        if name == 'jellyfish_emiss':
            par = testing.source_params(name, ROOT, file_format='fits',
                                        out_file=str(out))
            kb.reset_launch_counts()
            t0 = time.time()
            res = driver.run(par, device=device,
                             amr_data=amr_leaves('jellyfish'))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(kb.LAUNCHES)
            write_output(par.out_file, res)
        else:
            nml = source_variant(name, tmp)
            rc, res, wall, launches = run_cli(nml, out, device)
            assert rc == 0
        spec = read_spectrum(str(out))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == res.xfreq.shape
        add_launches(total, launches, SOURCE_PATHS[name])
        sub[name] = launches
        w = res.W_escape + res.W_absorb + res.W_oor
        par = res.cfg.par
        weighted = par.sampling_method > 0 and par.source_geometry.strip() \
            in ('star_file', 'diffuse_emissivity')
        w_birth = testing.birth_weight(res) if weighted else 1.0
        assert abs(w - w_birth) < 1e-3, (name, w, w_birth)
        extra = ''
        if par.save_peeloff:
            with open_read(str(Path(tmp) / f'{name}_peel3D.fits')) as f:
                cube = np.asarray(f['Scattered/data'])
            assert np.all(np.isfinite(cube)) and cube.sum() > 0
            extra += f', _peel3D {cube.shape}'
        if par.save_sightline_tau:
            with open_read(str(Path(tmp) / f'{name}_tau.fits')) as f:
                tau = np.asarray(f['tau_gas/data'])
            assert np.all(np.isfinite(tau))
            extra += f', _tau {tau.shape}'
        log(4, f'{name} ({res.nphotons} photons, '
               f'{par.source_geometry.strip()}, '
               f'{par.spectral_type.strip()}, FITS): W_esc '
               f'{res.W_escape:.6f} + W_abs {res.W_absorb:.6f} + W_oor '
               f'{res.W_oor:.6f} = {w:.6f} against the birth weights '
               f'{w_birth:.6f}, <N_scatt> {res.nscatt_gas:.4f}{extra}, wall '
               f'{wall:.1f} s; launches {launches}')


def inside_phase3(dev):
    """driver.run on cuda and on cpu with an interior observer at the
    centre of a 17^3 shell (r 0.5-1, tau 2, a central point source; lart_tpu's
    tests/test_healpix.py:95 shell, where the 1/r^2 weights stay bounded),
    with save_sightline_tau: the spectra, the all-sky scattered map's
    isotropy and total, and the tau maps of K11 and its plain version."""
    from lart_tpu_torch import testing
    par = testing.sphere_params(tau0=2.0, n=17, nphotons=4000, batch=4096,
                                save_Jmu=True, nmu=8, rmin=0.5,
                                save_peeloff=True, nside=2,
                                save_sightline_tau=True)
    rg, tg, counts, rc, tc = cuda_and_cpu(par, dev)
    assert all(counts.get(k) for k in ('refill_point', 'fly_cartesian',
                                       'scatter_lya', 'peel', 'sightline'))
    chi2, dmu = testing.spectra_agree(
        *testing.run_tallies(rg), *testing.run_tallies(rc), par.nphotons,
        par.nmu)
    sky = [r.peel['scatt'][0].sum(axis=0)[:, 0] for r in (rg, rc)]
    iso = [float(m.std() / m.mean()) for m in sky]
    tot = float(sky[0].sum() / sky[1].sum())
    assert min(float(m.min()) for m in sky) > 0 and max(iso) < 0.15, iso
    assert abs(tot - 1.0) < 0.1, tot
    for k in ('tau_gas', 'N_gas', 'tau_dust'):
        np.testing.assert_allclose(rg.sightline[0][k], rc.sightline[0][k],
                                   rtol=1e-5, atol=1e-6)
    log(3, f'interior observer at the centre of a 17^3 shell (tau 2, '
           f'nside 2, {par.nphotons} photons, save_sightline_tau): <N> cuda '
           f'{rg.nscatt_gas:.3f} ({tg:.1f} s) cpu {rc.nscatt_gas:.3f} '
           f'({tc:.1f} s), chi2/dof {chi2:.2f}, Jmu max |d| {dmu:.4f}; '
           f'all-sky scattered map rel spread cuda {iso[0]:.4f} cpu '
           f'{iso[1]:.4f}, total cuda / cpu {tot:.4f}; tau maps equal to '
           f'1e-5; launches {counts}')


def inside_cli(tmp, device, total):
    """The slice's main path through the CLI, FITS written and read back:
    CIV_test.in as written with save_peeloff on (1e5 photons; the C IV
    doublet, the exponential cylinder, the interior observer at (-8.5, 0,
    0) kpc, nside 64, save_sightline_tau): W_esc + W_oor = 1, <N_scatt>
    beside examples/RUNLOG.md's 14.54 (2000 photons), the _peel3D and
    _peel2D HEALPix maps (121, 49152) with NSIDE 64, the _tau file; and
    the standalone sightline tool on both sightline_tau examples as
    written, N_gas held against the analytic chord of their uniform
    sphere.  Their launch counts go into total['inside']."""
    from lart_tpu_torch.instruments import sightline as tsl
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.tools import make_sightline_tau as tool
    nml = namelist_variant(CIV, tmp, save_peeloff='.true.',
                           save_peeloff_2D='.true.')
    out = Path(tmp) / 'CIV_test.fits'
    rc, res, wall, launches = run_cli(nml, out, device)
    assert rc == 0
    w = res.W_escape + res.W_oor
    assert abs(w - 1.0) < 1e-3, (res.W_escape, res.W_oor)
    ratio = res.nscatt_gas / CIV_NSCATT
    assert abs(ratio - 1.0) < 0.1, res.nscatt_gas
    need = ('refill_radial', 'fly_cartesian', 'scatter_lya', 'peel',
            'sightline')
    add_launches(total, launches, need)
    total['inside'] = dict(launches)
    om = res.obs_meta
    assert om.inside and om.nside == CIV_NSIDE, om
    shapes = {}
    for suffix in ('_peel3D', '_peel2D'):
        with open_read(str(Path(tmp) / f'CIV_test{suffix}.fits')) as f:
            for name in ('Scattered', 'Direct'):
                a = np.asarray(f[f'{name}/data'])
                attrs = f[name].attrs
                assert np.all(np.isfinite(a)) and a.sum() > 0, (suffix, name)
                assert int(attrs['NSIDE']) == om.nside and str(
                    attrs['PIXTYPE']).strip() == 'HEALPIX', (suffix, attrs)
                shapes[suffix] = a.shape
    assert shapes['_peel3D'] == (res.meta.nxfreq, om.npix)
    assert shapes['_peel2D'] == (om.npix, 1)
    with open_read(str(Path(tmp) / 'CIV_test_tau.fits')) as f:
        tau = np.asarray(f['tau_gas/data'])
        ngas = np.asarray(f['N_gas/data'])
    assert tau.shape == (res.meta.nxfreq, om.npix, 1)
    assert np.all(np.isfinite(tau))
    assert float(ngas.min()) > 0.0
    log(4, f'CLI CIV_test.in with save_peeloff ({res.nphotons} photons, '
           f'FITS): W_esc {res.W_escape:.6f} + W_oor {res.W_oor:.6f} = '
           f'{w:.6f}, <N_scatt> {res.nscatt_gas:.4f} (RUNLOG 14.54 at 2000 '
           f'photons: ratio {ratio:.4f}), _peel3D {shapes["_peel3D"]}, '
           f'_peel2D {shapes["_peel2D"]}, NSIDE {om.nside}, _tau '
           f'{tau.shape}, N_gas '
           f'{float(ngas.min()):.4e}-{float(ngas.max()):.4e}, wall '
           f'{wall:.1f} s; launches {launches}')

    for rel in (SL_CAR, SL_INSIDE):
        nml = namelist_variant(rel, tmp)
        fn = Path(tmp) / (Path(rel).stem + '_tau.fits')
        kb.reset_launch_counts()
        t0 = time.time()
        assert tool.main([str(nml), str(fn), '--device', device]) == 0
        torch.cuda.synchronize()
        wall = time.time() - t0
        assert kb.LAUNCHES['sightline'] == 1
        total['sightline_tool'] = total.get('sightline_tool', 0) + 1
        with open_read(str(fn)) as f:
            ngas = np.asarray(f['N_gas/data'], np.float64).reshape(-1)
            tau = np.asarray(f['tau_gas/data'])
        # the analytic chord of the uniform sphere (R = 1 about the
        # origin), times the column density a unit length inside it
        from lart_tpu_torch.config import Params
        from lart_tpu_torch.grid.cartesian import build_cartesian
        par = Params.from_namelist(str(nml))
        par.save_peeloff = True
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=device)
        sl = tsl.Sightline.from_config(cfg, meta, grid)
        c = float(grid.rhokap.max()) * meta.Dfreq_ref / cfg.line.cross0
        _, k, hit, _ = tsl.ray_origins(sl, 0)
        o = sl.pos[0].double().cpu().numpy()
        kk = k.double().cpu().numpy()
        if sl.obs_meta.inside:
            ov = -(o[:, None] * kk).sum(0)
            L = -ov + np.sqrt(ov ** 2 - ((o ** 2).sum() - 1.0))
            sel = np.ones_like(L, bool)
        else:
            b2 = (np.cross(o, kk.T) ** 2).sum(1)
            L = 2.0 * np.sqrt(np.maximum(1.0 - b2, 0.0))
            sel = b2 < 0.64
        dev_rel = np.abs(ngas[sel] / (c * L[sel]) - 1.0)
        tot = ngas[sel].sum() / (c * L[sel]).sum()
        assert dev_rel.max() < 0.05 and abs(tot - 1.0) < 5e-3, (
            dev_rel.max(), tot)
        log(4, f'sightline tool {Path(rel).name} as written ({device}, '
               f'FITS): tau_gas {tau.shape}, N_gas against the analytic '
               f'chord of the uniform sphere on {int(sel.sum())} pixels: '
               f'max rel dev {dev_rel.max():.4f} (voxelized sphere), sum '
               f'ratio {tot:.6f}; wall {wall:.1f} s')


def inside_phase5(dev, res):
    """CIV_test.in with save_peeloff as written but for its budget (1e9
    photons): its steady-state window with the profile and the kernel
    times of K2 (exponential_cylinder), K5 and K4 (C IV doublet) and K7
    (interior), and K11's ms for one whole nside-64 map against its plain
    version and its bound."""
    from lart_tpu_torch.instruments import sightline as tsl
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    p, _ = rate_window('CIV_test with save_peeloff (C IV doublet, '
                       'exponential cylinder, interior observer nside 64)',
                       civ_params(**over), dev)
    card = smi()
    profile_chunks(p, card, 'CIV_test')
    kernel_times(p, card, 'CIV_test', res, ('refill_radial', 'fly_cartesian',
                                            'scatter_lya', 'peel'),
                 record=(('refill_radial', EXPCYL), ('peel', INSIDE)))
    sl = tsl.Sightline.from_config(p.cfg, p.meta, p.grid)
    stats = {}
    tsl.sightline_plain(sl, stats)
    ms = device_ms([lambda: tsl.sightline(sl)] * 5)
    call_ms, plain_ms = turns(lambda: tsl.sightline(sl),
                              lambda: tsl.sightline_plain(sl), 3,
                              plain_reps=1)
    bnd = bound(*sightline_work(sl, stats))
    res.setdefault('sightline', {}).update(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bnd[0],
                                           bound_by=bnd[1])
    log(5, f'CIV_test sightline (one whole map: {sl.npix} pixels x '
           f'{sl.ncol} columns, {stats["rays"]} rays, '
           f'{stats["gas"] + stats["col"]} crossings over {stats["cells"]} '
           f'distinct cells): kernel {ms:.6f} ms on the device, '
           f'{call_ms:.6f} ms a call; plain {plain_ms:.6f} ms a call; bound '
           f'{bnd[0]:.6f} ms ({bnd[1]}) [{card}]')
    del p


def sources_phase5(dev, res):
    """The volume and table sources' three windows, each as written but
    for its budget (1e9 photons): t4tau2.in (K2's volume instance, K6 in
    He I), stars1.in (the alias instance with composite weights, K5, K4
    with Stokes, K7) and halo_0053.in (the radial instance with the ssh
    table, K5 in its velocity field with dust, K4, K7): the rate, the
    profile, and each kernel's time against its plain version's and its
    bound (K7's, 80% of the peel cells' device time in the profile, is not
    timed against its plain walk here: ~1 s a call at 201^3); each K2
    instance's numbers go into res under its name."""
    from lart_tpu_torch import testing
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    cells = (
        ('t4tau2 (He I, uniform_sphere, continuum, 65^3 sphere, tau 100)',
         't4tau2', testing.source_params('t4tau2', ROOT, cut=False, **over),
         ('refill_volume', 'fly_uniform_sphere', 'scatter_lya')),
        ('stars1 (6 stars, composite weights, 201^3 cube, tau 1e5, '
         'core-skip, Stokes, 129x129 x 201 cube)', 'stars1',
         testing.source_params('stars1', ROOT, cut=False, **over),
         ('refill_alias', 'fly_cartesian', 'scatter_lya')),
        ('halo_0053 (ssh source and velocity field, 201^3, tau 2e6, dust, '
         'Stokes, 129x129 x 401 cube)', 'halo_0053',
         example_params('SSH_MUSE/halo_0053.in', **over),
         ('refill_radial', 'fly_cartesian', 'scatter_lya')))
    for label, key, par, names in cells:
        p, _ = rate_window(label, par, dev)
        card = smi()
        profile_chunks(p, card, key)
        kernel_times(p, card, key, res, names, record=(names[0],))
        del p


# --------------------------------------------------------------------------
# the per-cell temperature and the 3-D grid files
# --------------------------------------------------------------------------

def temperature_cube(tmp, n, seed=T_CUBE_SEED):
    """A FITS (n, n, n) temperature cube in tmp, 1e3-1e5 K log-uniform cell
    by cell from a seed (testing.temperature_cube; the card's machine has
    no h5py)."""
    from lart_tpu_torch import testing
    return testing.write_cube(Path(tmp) / f'T{n}.fits',
                              testing.temperature_cube(n, seed))


def birth_tally():
    """A context that sums the weight of every lane K2 launches (its
    birth weight) on the device, around the chunk loop's refill: the
    budget W_esc + W_abs + W_oor closes against this sum, the births
    outside the frequency band included (Jin counts those inside it)."""
    import contextlib
    from lart_tpu_torch.transport import engine

    @contextlib.contextmanager
    def ctx():
        total = []
        refill = engine.refill

        def counted(state, tallies, p, seed, counter, budget, record=None):
            dead = state.phase == 0
            refill(state, tallies, p, seed, counter, budget, record)
            total.append(torch.where(dead & (state.phase != 0), state.wgt,
                                     0.0).double().sum())
        engine.refill = counted
        try:
            yield total
        finally:
            engine.refill = refill
    return ctx()


def phase2_temperature(dev, res, batch=None):
    """The per-cell temperature against the plain versions at B = batch
    (B_MAIN), lane by lane, pair by pair or ray by ray: on
    emiss_1D_AlII/AlII_ex.in as written (101^3, its 1-D temperature
    profile: the slice's main path) K2's alias instance with each birth's
    cell's a and D, K5 (the static D1/D2 update, the escape bin at D /
    D_ref), K4 (and with local core-skip at the cell's a), K7 direct and
    resonance, K11's whole map; on the 201^3 Hubble grid of
    vel_effect/t4NHI2_20_V0200.in with a 1e3-1e5 K temperature cube (FITS)
    in Mg II 2796 (the kMulti instances: the doublet's offsets dnu / D per
    cell), with one observer: K2's point instance at its cell's a and D,
    K5, K4, K7, K11; on h2_test/h2_on.in's 101^3 grid with that cube (the
    kH2 instances): K2, K5, K4; and jellyfish_pt's leaves at their own
    temperature in Mg II and with H2 (K8's kMulti and kH2 instances, K2,
    K4, K7 with its observer)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.instruments import sightline as tsl
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.scatter import ScatterParams
    B = batch or B_MAIN
    seed = 1200
    fly_tal = ('Jout', 'Jmu', 'W_oor')

    def fly(meta, ch, key, what, r_max=None, state=None):
        nonlocal seed
        seed += 1
        s0, sk, frac, err, tal = both(meta, seed, fly_step(ch), fly_tal, dev,
                                      nmu=ch.nmu, r_max=r_max, state=state,
                                      h2=ch.h2)
        kept = (s0.phase == 2) & (sk.phase == 2)
        moved = kept & ((sk.ic != s0.ic) | (sk.jc != s0.jc)
                        | (sk.kc != s0.kc))
        shifted = int((moved & (sk.xfreq != s0.xfreq)).sum())
        assert shifted > 0, 'no comoving update on a cell change'
        _max_err(res, flight_kernel(ch) + key, err)
        log(2, f'  {flight_kernel(ch)} ({what}): {int(moved.sum())} lanes '
               f'changed cell, {shifted} of them their frequency; lanes '
               f'differing {frac:.2e}, max abs err {err:.3e}; tallies max '
               f'|d| {tal}')

    def births(meta, ch, key, what, state=None):
        nonlocal seed
        seed += 1
        _, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',),
                                     dev, state=state)
        name = ch.refill_params.kernel
        _max_err(res, name + key, err)
        log(2, f'  K2 {name} ({what}): lanes differing {frac:.2e}, max abs '
               f'err {err:.3e}, Jin max |d| {tal["Jin"]:.3e}')

    def scatter(meta, ch, key, what, sp=None, state=None, r_max=None,
                tals=('nscatt_gas', 'nscatt_events')):
        nonlocal seed
        seed += 1
        recs = {}
        _, sk, frac, err, tal = both(
            meta, seed, scatter_step(ch, sp, recs if ch.peel else None),
            tals, dev, state=state, r_max=r_max, h2=ch.h2)
        rerr = n_rec = 0
        if ch.peel is not None:
            n_rec, rerr = record_diff(recs[True], recs[False])
            assert n_rec <= MAX_FRAC * B, n_rec
        _max_err(res, 'scatter_lya' + key, max(err, rerr))
        log(2, f'  K4 scatter_lya ({what}): lanes differing {frac:.2e}, max '
               f'abs err {err:.3e}; record lanes differing {n_rec}; tallies '
               f'max |d| {tal}')

    def peel(meta, ch, key, what, r_max=None, state_fn=None,
             modes=('direct', 'resonance')):
        nonlocal seed
        for mname in modes:
            seed += 2
            n_bad, n_dep, err, dtau, dw = peel_both(
                ch, meta, seed, getattr(tpeel, mname.upper()), dev, r_max,
                state_fn=state_fn)
            _max_err(res, 'peel' + key, err)
            log(2, f'  K7 peel {mname} ({what}): {n_dep} pairs deposit, '
                   f'pairs differing {n_bad}, max |d tau| {dtau:.3e}, '
                   f'per-pair deposits max rel err {dw:.3e}, cubes max abs '
                   f'err {err:.3e}')

    def sightline(cfg, meta, grid, key, what):
        sl = tsl.Sightline.from_config(cfg, meta, grid)
        assert sl.comoving
        n_bad, n, err, nerr, stats = sightline_both(sl)
        _max_err(res, 'sightline' + key, max(err, nerr))
        log(2, f'  K11 sightline ({what}: {sl.npix} pixels x {sl.ncol} '
               f'columns): rays differing {n_bad} of {n}, max abs err '
               f'{err:.3e}, N_gas max rel err {nerr:.3e}')

    # the slice's main path: AlII_ex.in as written
    t0 = time.time()
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        'AlII', ROOT, batch_size=B), dev)
    assert not meta.uniform_temperature and ch.refill_params.cell_D \
        is not None and flight_kernel(ch) == 'fly_cartesian'
    D = grid.Dfreq
    log(2, f'AlII_ex.in as written (101^3, T from the 1-D profile, '
           f'D_cell / D_ref {float(D.min()) / meta.Dfreq_ref:.4f}-'
           f'{float(D.max()) / meta.Dfreq_ref:.4f}): built in '
           f'{time.time() - t0:.1f} s')
    R = cfg.par.rmax
    births(meta, ch, TEMP, 'the 1-D emissivity profile, each birth at its '
                           'cell\'s a and D')
    fly(meta, ch, TEMP, 'static, line type 1', R)
    scatter(meta, ch, TEMP, 'line type 1, recoil', r_max=R)
    c2 = testing.source_params('AlII', ROOT, batch_size=B, core_skip=True,
                               taumax=1e6).resolve()
    m2, g2 = build_cartesian(c2, device=dev)
    sp2 = ScatterParams.from_config(c2, m2, g2)
    scatter(m2, ch, TEMP, 'local core-skip at the cell\'s a, tau 1e6', sp2,
            r_max=R)
    del g2, sp2
    peel(meta, ch, TEMP, 'the DDA at each cell\'s a and D, 120x120', R)
    sightline(cfg, meta, grid, TEMP, 'AlII_ex.in\'s map')
    del ch, grid

    with tempfile.TemporaryDirectory() as tmp:
        # the Mg II doublet on the 201^3 Hubble grid with a T cube
        t0 = time.time()
        tfile = temperature_cube(tmp, 201)
        par = example_params(VEL_EFFECT, batch_size=B, temp_file=tfile,
                             nwavelength=100, nxim=33, nyim=33, **MGII,
                             **OBSERVER)
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        log(2, f'the 201^3 Hubble grid in Mg II 2796 with a 1e3-1e5 K '
               f'temperature cube: built in {time.time() - t0:.1f} s')
        births(meta, ch, TEMP, 'the point source at its cell\'s a and D, '
                               'Mg II (the branch shift at D_src)')
        fly(meta, ch, TEMP, 'Hubble, Mg II (kMulti)', 1.0)
        sp = ch.scatter_params
        q = pline_prof(sp)
        st = testing.line_state(meta, B, seed + 7, [0.0, -q.dx[1]],
                                width=3.0, device=dev)
        scatter(meta, ch, TEMP, 'Mg II, recoil off', state=st)
        peel(meta, ch, TEMP, 'Mg II, the walk in the Hubble flow', 1.0)
        sightline(cfg, meta, grid, TEMP, 'Mg II, Hubble, 33x33')
        del ch, grid

        # H2 pumping on h2_on.in's grid with a T cube (the kH2 instances)
        tfile = temperature_cube(tmp, 101)
        cfg = example_params(H2_ON, batch_size=B, temp_file=tfile).resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        ch = make_chunk(cfg, meta, grid)
        sp = ch.scatter_params
        births(meta, ch, TEMP, 'h2_on with the T cube')
        fly(meta, ch, TEMP, 'h2_on with the T cube, H2 opacity (kH2)', 1.0)
        centres = [float(np.float32(d) / np.float32(sp.Dfreq))
                   for d in sp.h2.dnu]
        st = testing.line_state(meta, B, seed + 9, centres + [0.0],
                                width=1.5, device=dev)
        scatter(meta, ch, TEMP, 'h2_on with the T cube, H2 (kH2), local '
                                'core-skip', state=st,
                tals=('nscatt_gas', 'nscatt_events', 'W_H2abs', 'W_H2scat',
                      'W_H2pump'))
        del ch, grid

    # jellyfish_pt's leaves at their own temperature: Mg II and H2
    jelly = amr_leaves('jellyfish')
    for what, over in (('Mg II 2796 (kMulti)', MGII),
                       ('H2 f_H2 0.03 (kH2)', dict(
                           h2_model='neufeld', f_H2=0.03,
                           h2_temperature=8000.0))):
        par = example_params(JELLY, batch_size=B, **over)
        meta, ch, t_build, _ = amr_chunk(par, jelly, dev)
        amr = ch.flight.amr
        assert not meta.uniform_temperature
        log(2, f'jellyfish_pt\'s leaves (8e3 / 3e5 K) in {what}: built in '
               f'{t_build:.1f} s')

        def state(sd):
            return testing.amr_state(meta, amr, B, sd, dev)
        births(meta, ch, LEAF_T, f'jellyfish, {what}', state(seed + 11))
        fly(meta, ch, LEAF_T, f'jellyfish, {what}', state=state(seed + 13))
        scatter(meta, ch, LEAF_T, f'jellyfish, {what}',
                state=testing.amr_state(meta, amr, B, seed + 15, dev,
                                        phases=(3,)))
        peel(meta, ch, LEAF_T, f'jellyfish, {what}, its observer',
             state_fn=state, modes=('resonance',))
        del ch


def pline_prof(sp):
    """The line's components at the reference a and D of ScatterParams sp."""
    from lart_tpu_torch.physics import line as pline
    return pline.line_prof(sp.line, sp.a, sp.Dfreq)


def temperature_cli(tmp, device, total):
    """The per-cell temperature and the 3-D cubes through the CLI, FITS
    written and read back: emiss_1D_AlII/AlII_ex.in as written (the
    slice's main path: W_esc + W_abs + W_oor against the birth weights
    summed on the device, <N_scatt> beside lart_tpu's CPU run of it,
    tools/temperature_cpu_runs.py, the _peel3D and _tau files);
    FeII_turb/FeII_UV1_V100.in with its Mach-10 65^3 density cube written
    as FITS from testing.turb_cube (the card has no h5py to read the
    example's HDF5 cube), photons cut to FEII_PHOTONS; Prochaska/MgII_a.in
    as written but for its photons (MGII_A_PHOTONS), its 150^3 r^-2 cube
    written as gz FITS from testing.prochaska_dens; and jellyfish_pt's
    leaves at their own temperature in Mg II through driver.run (taumax
    JELLY_T_TAU, JELLY_T_PHOTONS photons).  Each run's launches go into
    total['temperature'][name]."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum, write_output
    from lart_tpu_torch.kernels import build as kb
    sub = total.setdefault('temperature', {})

    def check(name, res, out, w_birth, extra=''):
        spec = read_spectrum(str(out))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and jout.shape == res.xfreq.shape
        w = res.W_escape + res.W_absorb + res.W_oor
        assert abs(w - w_birth) < 1e-3, (name, w, w_birth)
        return (f'W_esc {res.W_escape:.6f} + W_abs {res.W_absorb:.6f} + '
                f'W_oor {res.W_oor:.6f} = {w:.6f} against the birth weights '
                f'{w_birth:.6f}, <N_scatt> {res.nscatt_gas:.4f}{extra}')

    # AlII_ex.in as written
    name = 'AlII'
    nml = source_variant(name, tmp)
    out = Path(tmp) / 'AlII.fits'
    with birth_tally() as born:
        rc, res, wall, launches = run_cli(nml, out, device)
    assert rc == 0 and not res.meta.uniform_temperature
    w_birth = float(torch.stack(born).sum()) / res.nphotons
    with open_read(str(Path(tmp) / 'AlII_peel3D.fits')) as f:
        cube = np.asarray(f['Scattered/data'])
    with open_read(str(Path(tmp) / 'AlII_tau.fits')) as f:
        tau = np.asarray(f['tau_gas/data'])
    assert np.all(np.isfinite(cube)) and cube.sum() > 0
    assert np.all(np.isfinite(tau)) and tau.max() > 0
    ratio = res.nscatt_gas / ALII_CPU[0]
    assert abs(ratio - 1.0) < 0.05, (res.nscatt_gas, ALII_CPU)
    msg = check(name, res, out, w_birth, f' (lart_tpu on the CPU '
                f'{ALII_CPU[0]} with {ALII_CPU[1]} photons: ratio '
                f'{ratio:.4f}), Jin\'s sum {testing.birth_weight(res):.6f}, '
                f'_peel3D {cube.shape}, _tau {tau.shape} max '
                f'{float(tau.max()):.4g}')
    add_launches(total, launches, TEMP_PATH)
    sub[name] = launches
    log(4, f'CLI AlII_ex.in as written ({res.nphotons} photons, 101^3, T '
           f'8900-7100 K, FITS): {msg}, wall {wall:.1f} s; launches '
           f'{launches}')

    # FeII_UV1_V100.in with its turbulent cube as FITS
    cube = testing.write_cube(Path(tmp) / 'turb_cube.fits',
                              testing.turb_cube())
    nml = namelist_variant('FeII_turb/FeII_UV1_V100.in', tmp,
                           dens_file=f"'{cube}'",
                           no_photons=f'{FEII_PHOTONS:g}')
    out = Path(tmp) / 'FeII_UV1_V100.fits'
    rc, res, wall, launches = run_cli(nml, out, device)
    assert rc == 0 and res.cfg.line.line_type == 5
    msg = check('FeII_UV1_V100', res, out, 1.0)
    add_launches(total, launches, ('refill_point', 'fly_cartesian',
                                   'scatter_lya', 'peel'))
    sub['FeII_UV1_V100'] = launches
    log(4, f'CLI FeII_turb/FeII_UV1_V100.in (photons cut to {res.nphotons}, '
           f'the lognormal Mach-10 65^3 cube as FITS, Fe II UV1 type 5, '
           f'Hubble 100 km/s, Stokes, FITS): {msg}, wall {wall:.1f} s; '
           f'launches {launches}')

    # Prochaska/MgII_a.in with its r^-2 cube as gz FITS
    cube = testing.write_cube(Path(tmp) / 'MgII_a_dens.fits.gz',
                              testing.prochaska_dens())
    nml = namelist_variant('Prochaska/MgII_a.in', tmp, dens_file=f"'{cube}'",
                           no_photons=f'{MGII_A_PHOTONS:g}')
    out = Path(tmp) / 'MgII_a.fits'
    rc, res, wall, launches = run_cli(nml, out, device)
    assert rc == 0 and res.cfg.line.line_type == 2
    msg = check('MgII_a', res, out, 1.0)
    add_launches(total, launches, ('refill_volume', 'fly_cartesian',
                                   'scatter_lya'))
    sub['MgII_a'] = launches
    log(4, f'CLI Prochaska/MgII_a.in (photons cut to {res.nphotons}, the '
           f'150^3 r^-2 cube as gz FITS, Mg II doublet, Hubble 1000 km/s, '
           f'FITS): {msg}, wall {wall:.1f} s; launches {launches}')

    # jellyfish_pt's leaves at their own temperature in Mg II
    par = example_params(JELLY, taumax=JELLY_T_TAU, nphotons=JELLY_T_PHOTONS,
                         file_format='fits',
                         out_file=str(Path(tmp) / 'jelly_mg.fits'), **MGII)
    kb.reset_launch_counts()
    t0 = time.time()
    res = driver.run(par, device=device, amr_data=amr_leaves('jellyfish'))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kb.LAUNCHES)
    write_output(par.out_file, res)
    msg = check('jellyfish Mg II', res, par.out_file, 1.0)
    add_launches(total, launches, ('refill_point', 'fly_amr', 'scatter_lya',
                                   'peel'))
    sub['jellyfish_mg'] = launches
    log(4, f'jellyfish_pt in Mg II 2796 (leaves at 8e3 / 3e5 K, taumax '
           f'{JELLY_T_TAU:g}, {res.nphotons} photons, its observer): {msg}, '
           f'wall {wall:.1f} s; launches {launches}')


def temperature_phase5(dev, res):
    """AlII_ex.in as written but for its budget (1e9 photons): its
    steady-state window, the profile, the kernel times of K2's alias
    instance, K5, K4 and K7 at each cell's a and D against their plain
    versions and bounds, and K11's ms for AlII_ex.in's whole map; and a
    window of jellyfish_pt's leaves in Mg II (K8's kMulti instance at each
    leaf's a and D)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import sightline as tsl
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    p, _ = rate_window('AlII_ex.in as written (Al II 1671, 101^3, T 8900-'
                       '7100 K, diffuse_emissivity, recoil, one observer '
                       '120x120 x 121)',
                       testing.source_params('AlII', ROOT, **over), dev)
    card = smi()
    profile_chunks(p, card, 'AlII')
    kernel_times(p, card, 'AlII', res, ('refill_alias', 'fly_cartesian',
                                        'scatter_lya', 'peel'),
                 record=('refill_alias', 'fly_cartesian', 'scatter_lya',
                         'peel'), suffix=TEMP)
    sl = tsl.Sightline.from_config(p.cfg, p.meta, p.grid)
    stats = {}
    tsl.sightline_plain(sl, stats)
    ms = device_ms([lambda: tsl.sightline(sl)] * 5)
    call_ms, plain_ms = turns(lambda: tsl.sightline(sl),
                              lambda: tsl.sightline_plain(sl), 3,
                              plain_reps=1)
    bnd = bound(*sightline_work(sl, stats))
    res.setdefault('sightline' + TEMP, {}).update(
        ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
    log(5, f'AlII sightline (one whole map: {sl.npix} pixels x {sl.ncol} '
           f'columns, {stats["rays"]} rays, {stats["gas"] + stats["col"]} '
           f'crossings over {stats["cells"]} distinct cells): kernel '
           f'{ms:.6f} ms on the device, {call_ms:.6f} ms a call; plain '
           f'{plain_ms:.6f} ms a call; bound {bnd[0]:.6f} ms ({bnd[1]}) '
           f'[{card}]')
    del p
    p, _ = rate_window('jellyfish_pt in Mg II 2796 (4432 leaves at 8e3 / '
                       '3e5 K, its observer)',
                       example_params(JELLY, **over, **MGII), dev,
                       amr_data=amr_leaves('jellyfish'))
    card = smi()
    profile_chunks(p, card, 'jellyfish_mg')
    kernel_times(p, card, 'jellyfish_mg', res, ('fly_amr',),
                 record=('fly_amr',), suffix=LEAF_T)
    del p


def device_ms(calls):
    """Device ms per launch of calls[i](): a sleep holds the stream while
    the host enqueues every call, so the launches run back to back and the
    host's launch time stays outside the events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for c in calls:
        c()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(calls)


def profile_chunks(p, card, label, n_chunks=4, split_peel=False):
    """Where a chunk's device time goes: torch.profiler (CUPTI) over
    n_chunks chunks of the prepared run, each device op's time and its
    share, and the device's busy share of the profiled wall time.  The
    profiler lengthens the host's side of a cycle, so the busy share is a
    lower bound on the unprofiled one.  With split_peel, K7's launches
    are split by the kernel launched before them in device order: after
    K2 the newborns' peel (direct or stellar), after K4 the scatterings'
    (both modes run one instance, so one profiler row)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lart_tpu_torch import driver
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            driver.chunk_to_host(*p.run_chunk())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = sorted(((getattr(e, 'self_device_time_total', 0.0), e.count, e.key)
                  for e in prof.key_averages()), reverse=True)
    ops = [o for o in ops if o[0] > 0]
    busy = sum(o[0] for o in ops)
    cycles = n_chunks * p.chunk.n_cycles
    if busy == 0:
        log(5, f'{label} profile of {cycles} cycles: the profiler saw no '
               f'device time; device busy share not measured [{card}]')
        return
    for us, count, key in ops[:6]:
        log(5, f'{label} profile: {key[:40]}: {us / count:.3f} us a launch x '
               f'{count} = {100 * us / busy:.2f}% of device time [{card}]')
    log(5, f'{label} profile of {cycles} cycles: device busy {busy:.1f} us '
           f'of {wall_us:.1f} us wall = {100 * busy / wall_us:.2f}% under the '
           f'profiler [{card}]')
    if split_peel:
        seq = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        after = {'refill': [], 'scatter': []}
        last = None
        for _, us, name in seq:
            if 'peel_kernel' in name and last in after:
                after[last].append(us)
            for k, stem in (('refill', 'refill_point_kernel'),
                            ('fly', 'void fly_'),
                            ('scatter', 'scatter_lya_kernel')):
                if stem in name:
                    last = k
        for k, what in (('refill', 'the newborns\' peel, after K2'),
                         ('scatter', 'the scatterings\' peel, after K4')):
            t = after[k]
            log(5, f'{label} profile: K7 {what}: ' + (
                f'{sum(t) / len(t):.3f} us a launch x {len(t)} = '
                f'{100 * sum(t) / busy:.2f}% of device time' if t else
                'no launch seen (not measured)') + f' [{card}]')


def kernel_times(p, card, label, res, names, record=(), reps=20, suffix=''):
    """Each kernel of the prepared run's cycle against its plain version,
    on one cycle's inputs at the steady-state shapes, beside its bound; the
    numbers of the kernels named in `record` go into res (under the
    kernel's name + suffix, or + s for an entry (name, s)).  With peel-off
    the refill and the scatter write a peel record as on the main path, and
    K7 peels the cycle's scattering events (resonance and, with dust, dust
    events, one launch as the chunk loop makes it)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.physics.voigt import voigt, voigt_plain
    from lart_tpu_torch.transport import refill, scatter
    from lart_tpu_torch.transport.state import DEAD
    ch, st = p.chunk, p.state
    fmod = sys.modules[type(ch.flight).__module__]
    tl = ch.zero_tallies(st.device)
    tl.allph = ch.allph     # save_all_photons: the run's table

    def new_record():
        return None if ch.peel is None else tpeel.PeelRecord.zeros(
            st.batch, st.device)
    rec, scratch = new_record(), new_record()
    pre_refill = testing.clone_state(st)
    refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, p.budget, rec)
    pre_fly = testing.clone_state(st)
    ch.flight(st, tl, ch.fly_substeps)
    pre_scatter = testing.clone_state(st)
    work = testing.clone_state(st)
    # the cycle's scattering events, as K7 reads them on the main path
    post = testing.clone_state(st)
    scatter.scatter(post, tl, ch.scatter_params, p.seed, p.cycle, rec)
    torch.cuda.synchronize()
    c = p.cycle
    fly_name = flight_kernel(ch)
    steps = {
        ch.refill_params.kernel: (
            pre_refill,
            lambda s: refill.refill(s, tl, ch.refill_params, 1, c, p.budget,
                                    scratch),
            lambda s: refill.refill_plain(s, tl, ch.refill_params, 1, c,
                                          p.budget, scratch)),
        fly_name: (
            pre_fly,
            lambda s: fmod.fly(s, tl, ch.flight, ch.fly_substeps),
            lambda s: fmod.fly_plain(s, tl, ch.flight, ch.fly_substeps)),
        'scatter_lya': (
            pre_scatter,
            lambda s: scatter.scatter(s, tl, ch.scatter_params, 1, c,
                                      scratch),
            lambda s: scatter.scatter_plain(s, tl, ch.scatter_params, 1, c,
                                            scratch)),
    }
    out = {}
    for k in names:
        if k == 'voigt_h':
            xs = pre_fly.xfreq.clone()
            a_ref = ch.scatter_params.a
            out[k] = (device_ms([lambda: voigt(xs, a_ref)] * reps),
                      *turns(lambda: voigt(xs, a_ref),
                             lambda: voigt_plain(xs, a_ref), reps),
                      bound(*kernel_work(k, pre_fly, ch, p.meta)))
            continue
        if k == 'peel':
            # the plain walk takes up to seconds a call: 2 calls a turn
            cubes = ch.peel.zero_cubes(st.device)
            mode = ch.peel.scatter_mode
            stats = {'lanes': int((rec.flag != 0).sum()), 'mode': mode}
            tpeel.peel_plain(post, cubes, rec, ch.peel, mode, stats=stats)

            def kern():
                tpeel.peel(post, cubes, rec, ch.peel, mode)

            def plain():
                tpeel.peel_plain(post, cubes, rec, ch.peel, mode)
            out[k] = (device_ms([kern] * reps),
                      *turns(kern, plain, reps, plain_reps=2),
                      bound(*kernel_work(k, post, ch, p.meta, stats)))
            log(5, f'{label} peel work: {stats["lanes"]} scattered lanes '
                   f'({stats["seen"]} with a pair in an image, '
                   f'{stats["seen_dust"]} of them at a dust event, '
                   f'{stats["seen_conv"]} at a conversion), '
                   f'{stats["pairs"]} (observer, lane) pairs walked, '
                   f'{stats.get("crossings", 0)} cell crossings over '
                   f'{stats["cells"]} distinct cells, {stats["bins"]} '
                   f'distinct cube bins')
            continue
        pre, kern, plain = steps[k]
        copies = [testing.clone_state(pre) for _ in range(reps)]
        dev_ms = device_ms([lambda s=s: kern(s) for s in copies])
        del copies
        # the plain versions take 5 ms to 1 s a call (more on a slow host):
        # 2 a turn keep the script inside its time limit
        call_ms, plain_ms = turns(
            lambda: kern(work), lambda: plain(work), reps,
            lambda: testing.copy_state_(work, pre), plain_reps=2)
        stats = {}
        if k in ('fly_cartesian', 'fly_amr', 'fly_clump_dense',
                 'fly_clump_csr'):
            # the steps the walk takes on these inputs (its H2 flops; K8's
            # distinct nodes; K9's crossed chords; K10's distinct cells)
            done = testing.clone_state(pre)
            fmod.fly_plain(done, tl, ch.flight, ch.fly_substeps, stats=stats)
            stats['deaths'] = int(((pre.phase != DEAD)
                                   & (done.phase == DEAD)).sum())
        elif k == 'scatter_lya' and ch.allph is not None:
            done = testing.clone_state(pre)
            scatter.scatter_plain(done, tl, ch.scatter_params, 1, c)
            stats['deaths'] = int(((pre.phase != DEAD)
                                   & (done.phase == DEAD)).sum())
        out[k] = dev_ms, call_ms, plain_ms, bound(*kernel_work(
            k, pre, ch, p.meta, stats))
    keys = dict((r, r + suffix) if isinstance(r, str) else (r[0], ''.join(r))
                for r in record if r is not None)
    for k, (dev_ms, call_ms, plain_ms, bnd) in out.items():
        if k in keys:
            res.setdefault(keys[k], {}).update(ms=dev_ms, plain_ms=plain_ms,
                                               bound_ms=bnd[0],
                                               bound_by=bnd[1])
        log(5, f'{label} {k} at B={st.batch}: kernel {dev_ms:.6f} ms on the '
               f'device (back to back), {call_ms:.6f} ms a call with its '
               f'launch; plain {plain_ms:.6f} ms a call; bound {bnd[0]:.6f} '
               f'ms ({bnd[1]}) [{card}]')


def branch_shift_share(p, card, label, reps=20):
    """K2's device ms on the prepared run's state (as its last chunk left
    it, the state the next refill sees) with and without branch_init_shift
    (the same line constants but for the flag), in turns with, without, without, with: the shift's share of
    K2's time."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport import refill
    from lart_tpu_torch.transport.state import zero_tallies
    rp = p.chunk.refill_params
    off = dataclasses.replace(rp, line=dataclasses.replace(
        rp.line, branch_init=False))
    tl = zero_tallies(p.meta.nxfreq, 0, p.state.device)
    pre = testing.clone_state(p.state)

    def run(params):
        copies = [testing.clone_state(pre) for _ in range(reps)]
        return device_ms([lambda s=s: refill.refill(s, tl, params, 1, p.cycle,
                                                    p.budget)
                          for s in copies])
    on1, off1, off2, on2 = run(rp), run(off), run(off), run(rp)
    on, without = 0.5 * (on1 + on2), 0.5 * (off1 + off2)
    n_dead = int((pre.phase == 0).sum())
    log(5, f'{label} refill_point with branch_init_shift {on:.6f} ms, '
           f'without {without:.6f} ms ({n_dead} dead lanes launched): the '
           f'shift takes {100 * (on - without) / on:.1f}% of K2 [{card}]')


def window(p, min_s, reduce=True):
    """(gas scatterings, seconds, chunks) of whole chunks of the prepared
    run until at least min_s seconds have passed (host clock between two
    synchronisations); each chunk's tallies all-reduced in a process group
    unless reduce is False."""
    from lart_tpu_torch import driver
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsc, n = 0.0, 0
    while True:
        nsc += driver.chunk_to_host(*p.run_chunk(),
                                    reduce=reduce)['nscatt_gas']
        n += 1
        if time.perf_counter() - t0 >= min_s:
            break
    return nsc, time.perf_counter() - t0, n


def rate_window(label, par, dev, min_s=WINDOW_S, amr_data=None):
    """Steady-state rate: 3 warm-up chunks, then whole chunks until at least
    min_s seconds have passed (host clock between two synchronisations);
    all gas scatterings over all the window's time.  Returns the prepared
    run and the rate."""
    from lart_tpu_torch import driver
    t0 = time.time()
    p = driver.prepare(par, seed=12345, device=dev, amr_data=amr_data)
    t_prep = time.time() - t0
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    card = smi()
    nsc, dt, n = window(p, min_s)
    cycles = n * par.chunk_cycles
    rate = nsc / dt
    log(5, f'{label} B={par.batch_size} fly_substeps {par.fly_substeps} '
           f'(set-up {t_prep:.1f} s): {nsc:.6e} gas scatterings in '
           f'{dt:.6f} s over {n} chunks x {par.chunk_cycles} cycles = '
           f'{rate:.6e} scatterings/s, {dt / cycles * 1e6:.3f} us a cycle '
           f'[{card}]')
    return p, rate


def phase5(dev, res):
    from lart_tpu_torch import driver, testing
    par = testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                              batch=B_MAIN, chunk_cycles=32, refill_every=4,
                              scatter_rounds=4, save_Jmu=False)
    p = driver.prepare(par, seed=12345, device=dev)
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    card = smi()
    # one window of at least FLAGSHIP_CHUNKS chunks and WINDOW_S seconds,
    # whole parts of SPREAD_CHUNKS chunks, all scatterings over all its
    # time; the rates of its parts are printed as the spread.
    # chunk_to_host reads the device, so each mark follows a sync.
    torch.cuda.synchronize()
    marks, parts, part, n = [time.perf_counter()], [], 0.0, 0
    while n < FLAGSHIP_CHUNKS or n % SPREAD_CHUNKS \
            or marks[-1] - marks[0] < WINDOW_S:
        part += driver.chunk_to_host(*p.run_chunk())['nscatt_gas']
        n += 1
        if n % SPREAD_CHUNKS == 0:
            marks.append(time.perf_counter())
            parts.append(part)
            part = 0.0
    dt = marks[-1] - marks[0]
    nsc = sum(parts)
    rate = nsc / dt
    spread = [v / (t1 - t0) for v, t0, t1 in zip(parts, marks, marks[1:])]
    log(5, f'flagship tau0=1e6 nz=201 B={B_MAIN}: {nsc:.6e} gas scatterings'
           f' in {dt:.6f} s over {n} chunks x {par.chunk_cycles} cycles = '
           f'{rate:.6e} scatterings/s, '
           f'{dt / (n * par.chunk_cycles) * 1e6:.3f} us a '
           f'cycle; parts of {SPREAD_CHUNKS} chunks: min {min(spread):.6e} '
           f'max {max(spread):.6e} [{card}]')
    profile_chunks(p, card, 'flagship')
    names = ('refill_point', 'fly_uniform_slab', 'scatter_lya', 'voigt_h')
    kernel_times(p, card, 'flagship', res, names, record=names)
    del p

    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    cells = (
        ('t4tau7 (tau 1e7, 129^3, core-skip)',
         example_params('sphere/t4tau7.in', **over), 'fly_uniform_sphere'),
        ('vel_effect V0200 (N_HI 2e20, 201^3, Hubble)',
         example_params('vel_effect/t4NHI2_20_V0200.in', **over),
         'fly_cartesian'),
        ('flagship slab through K5 (force_generic_kernel)',
         testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                             batch=B_MAIN, chunk_cycles=32, save_Jmu=False,
                             force_generic_kernel=True), None),
    )
    for label, cpar, fly_name in cells:
        p, _ = rate_window(label, cpar, dev)
        card = smi()
        profile_chunks(p, card, label.split(' ')[0])
        names = ('refill_point', fly_name or 'fly_cartesian', 'scatter_lya')
        kernel_times(p, card, label.split(' ')[0], res, names,
                     record=(fly_name,))
        del p

    # peel-off on: the three examples as written, K7 after K2 and K4
    peel_cells = (
        ('slab_peel (t1tau4: T 10 K, tau 1e4, 1x1x145, core-skip, Stokes, '
         '65x65 image)', 'slab_peel', 'fly_uniform_slab'),
        ('sphere_peel (t4tau4: tau 1e4, 65^3, Stokes, 65x65 image)',
         'sphere_peel', 'fly_uniform_sphere'),
        ('vel_effect_peel (V0200: N_HI 2e20, 201^3, Hubble, 500 x 65x65 '
         'cube)', 'vel_effect_peel', 'fly_cartesian'))
    for label, name, fly_name in peel_cells:
        p, _ = rate_window(label, example_params(PEEL_EXAMPLES[name], **over),
                           dev)
        card = smi()
        profile_chunks(p, card, name)
        kernel_times(p, card, name, res, ('refill_point', fly_name,
                                          'scatter_lya', 'peel'),
                     record=('peel',) if name == 'vel_effect_peel' else ())
        del p

    # dust (the Dijkstra & Loeb 2008 shell as written: its Gaussian births,
    # the walk with rhokapD, the scatter's Mueller dust branch), without and
    # with one observer on +z (K7 peels both kinds of event)
    dl_cells = (
        ('DL20e_dust (N_HI 1e20, DGR 1, 201^3, outflow 200 km/s, Stokes)',
         'DL20e_dust', {}),
        ('DL20e_dust_peel (the same, one observer on +z, 231 x 129x129 '
         'cube)', 'DL20e_dust_peel', OBSERVER))
    for label, name, extra in dl_cells:
        p, _ = rate_window(label, example_params(DL20E_DUST, **over, **extra),
                           dev)
        card = smi()
        profile_chunks(p, card, name)
        kernel_times(p, card, name, res, ('refill_point', 'fly_cartesian',
                                          'scatter_lya') + (
                                              ('peel',) if extra else ()))
        del p

    # the metal lines: the slice's main path, SiII_1193 as written with its
    # observer (K2 continuum, K5, K4 type 5 with Stokes and recoil, K7);
    # H + D Ly-alpha as written (K5, K4 type 7); He I 10833 (K6 type 6, K2
    # with the branch shift); the Mg II doublet on the flagship's slab (K3)
    ex = LINE_EXAMPLES
    line_cells = (
        ('SiII_1193 (type 5, 101^3, Hubble 200 km/s, continuum, recoil, '
         'Stokes, 100x100 x 240 cube)', 'SiII_1193',
         example_params(ex['SiII_1193'], **over),
         ('refill_point', 'fly_cartesian', 'scatter_lya', 'peel'),
         ('refill_point', 'fly_cartesian', 'scatter_lya', 'peel')),
        ('sphere_HD_dijkstra2006 (type 7, N_HI 1.2e19, 101^3 reflect, '
         'D/H 3e-5)', 'HD', example_params(ex['HD'], **over),
         ('refill_point', 'fly_cartesian', 'scatter_lya'), ()),
        ('HeI t4tau2 (type 6, tau 100, 101^3 sphere)', 'HeI',
         example_params(ex['HeI'], **over),
         ('refill_point', 'fly_uniform_sphere', 'scatter_lya'),
         ('fly_uniform_sphere',)),
        ('slab Mg II 2796 (type 2, tau0 1e6, nz 201, Voigt source)',
         'slab_MgII', testing.slab_params(
             tau0=1e6, nz=201, nphotons=10 ** 9, batch=B_MAIN,
             chunk_cycles=32, save_Jmu=False, line_id='MgII_2796',
             wavelength_min=2790.0, wavelength_max=2810.0),
         ('refill_point', 'fly_uniform_slab', 'scatter_lya'),
         ('fly_uniform_slab',)))
    for label, key, cpar, names, record in line_cells:
        p, _ = rate_window(label, cpar, dev)
        card = smi()
        profile_chunks(p, card, key)
        if key in ('SiII_1193', 'HeI'):
            # on the state a chunk leaves, which the next refill sees
            branch_shift_share(p, card, key)
        kernel_times(p, card, key, res, names, record=record, suffix=LINES)
        del p

    # this slice's examples as written: Ly-beta t4tau1e4.in with its
    # observer (K5 with the H-alpha band, K4's conversions, K7's conversion
    # peel), and h2_on.in (K5 and K4 with H2, core-skip)
    slice_cells = (
        ('t4tau1e4 (Ly-beta, type 8, 101^3, tau0 1e4, 51x51 x 121 cube)',
         'lyb', example_params(LYB, **over),
         ('refill_point', 'fly_cartesian', 'scatter_lya', 'peel'),
         ('fly_cartesian', 'scatter_lya', 'peel'), LT8),
        ('h2_on (Ly-alpha + H2 f_H2 0.03, 101^3, tau 1e5, core-skip)', 'h2',
         example_params(H2_ON, **over),
         ('refill_point', 'fly_cartesian', 'scatter_lya'),
         ('fly_cartesian', 'scatter_lya'), H2))
    for label, key, cpar, names, record, suffix in slice_cells:
        p, _ = rate_window(label, cpar, dev)
        card = smi()
        profile_chunks(p, card, key)
        kernel_times(p, card, key, res, names, record=record, suffix=suffix)
        del p
    for name, was in (('scatter_lya', 0.014622), ('fly_uniform_slab',
                                                   0.010883)):
        ms = res[name]['ms']
        log(5, f'flagship {name} (line type 1 instance) {ms:.6f} ms against '
               f'{was:.6f} ms before the line-type-8 and H2 branches (the '
               f'same measurement):'
               f' {100 * (ms / was - 1):+.1f}%')
    amr_phase5(dev, res)
    clump_phase5(dev, res)
    inside_phase5(dev, res)
    sources_phase5(dev, res)
    temperature_phase5(dev, res)
    atmosphere_phase5(dev, res)
    shear_phase5(dev, res)
    allph_phase5(dev, res)


# ---------------------------------------------------------------------------
# exoplanet atmospheres and the illumination sources
# ---------------------------------------------------------------------------

# K7's PEEL_STELLAR on a090 as written (the main path, whose pairs mostly
# miss the image) and on +z (the transit, whose pairs walk the atmosphere)
ATM, STELLAR_K, STELLAR_Z = ' (atmosphere)', ' (stellar)', ' (stellar, +z)'
# lart_tpu's CPU runs of the phase 4 cases (tools/atmosphere_cpu_runs.py
# NAME NPHOTONS SEED NBATCH): the photons, <N_scatt>, the Jabs2 share, the
# normalized flux factor and for a090_transit the transit depth, each with
# one photon's spread (_pp: the runs' standard error times sqrt(photons))
ATM_CPU = {
    'a090': dict(photons=200000, N=3.176343e-07, N_pp=6.401341e-06,
                 share=6.961814e-03, share_pp=9.966603e-02,
                 ff=1.634778e-02, ff_pp=1.639492e-02),
    'a090_transit': dict(photons=200000, N=3.014222e-07, N_pp=7.542575e-06,
                         share=6.716080e-03, share_pp=1.259110e-01,
                         ff=1.637762e-02, ff_pp=9.891361e-03,
                         depth=2.011561e-02, depth_pp=1.348028e-01),
    'wasp52b': dict(photons=4000, N=2.123886e+03, N_pp=6.170866e+03,
                    share=1.027922e-02, share_pp=3.501369e-02,
                    ff=1.641099e-04, ff_pp=9.639560e-05),
    'plane': dict(photons=20000, N=1.518701e+02, N_pp=5.700722e+02,
                  share=9.508285e-03, share_pp=7.895369e-02, ff=0.0,
                  ff_pp=0.0),
}


def limb_record(seed, dev):
    """rec_prep for peel_both's PEEL_STELLAR pairs: each lane's surface
    sample (cos theta uniform in [0, 1), vphi = 2 pi u) from a seed."""
    from lart_tpu_torch.physics.samplers import TWOPI

    def prep(rec):
        g = torch.Generator(device=dev).manual_seed(seed)
        rec.limb_cost.copy_(torch.rand(rec.flag.shape, generator=g,
                                       device=dev))
        rec.limb_vphi.copy_(TWOPI * torch.rand(rec.flag.shape, generator=g,
                                               device=dev))
    return prep


def refill_with_record(ch, meta, dev, seed, res, label, state=None):
    """K2 (the chunk's instance) against its plain version with the peel
    record each writes (the launch flags and, for a stellar source, each
    lane's limb sample) and the chunk's tallies (Jin, and an
    illumination's flux factor and rejected draws): lanes and record lanes
    differing, the tallies."""
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport import refill
    rp = ch.refill_params
    recs = {}

    def step(s, t, kernel):
        recs[kernel] = None if ch.peel is None else \
            tpeel.PeelRecord.zeros(s.batch, dev)
        (refill.refill if kernel else refill.refill_plain)(
            s, t, rp, 7, 12345, 10 ** 9, recs[kernel])
    tal = ('Jin',) + (('flux_factor', 'nrejected') if rp.illumination
                      else ())
    s0, sk, frac, err, tdiff = both(meta, seed, step, tal, dev, state=state,
                                    tallies=ch.zero_tallies)
    n_rec, rerr = (0, 0.0) if ch.peel is None else record_diff(
        recs[True], recs[False])
    assert n_rec <= MAX_FRAC * s0.batch, n_rec
    _max_err(res, rp.kernel + (ATM if rp.kernel == 'refill_point' else ''),
             max(err, rerr))
    born = s0.phase == 0
    w = sk.wgt[born].double()
    log(2, f'K2 {rp.kernel} ({label}): {int(born.sum())} births, weight '
           f'mean {float(w.mean()):.6f}; lanes differing {frac:.2e}, max abs '
           f'err {err:.3e}; record lanes differing {n_rec} (max abs err '
           f'{rerr:.3e}); tallies max |d| {tdiff}')
    return sk


def stellar_case(ch, meta, dev, seed, res, label, state_fn=None,
                 min_dep=0.05, key='peel' + STELLAR_K):
    """K7's PEEL_STELLAR against its plain version pair by pair (and its
    in-image pair count, the plain version's stats), its error in
    res[key]."""
    from lart_tpu_torch.instruments import peel as tpeel
    n_bad, n_dep, err, dtau, dw = peel_both(
        ch, meta, seed, tpeel.STELLAR, dev, state_fn=state_fn,
        rec_prep=limb_record(seed + 3, dev), min_dep=min_dep)
    _max_err(res, key, err)
    log(2, f'K7 peel stellar ({label}; {ch.peel.obs_meta.nxim}x'
           f'{ch.peel.obs_meta.nyim} x {meta.nxfreq} bins): {n_dep} of '
           f'{ch.peel.nobs * B_MAIN} pairs in the image and the band, pairs '
           f'differing {n_bad}, max |d tau| {dtau:.3e}, per-pair deposits '
           f'max rel err {dw:.3e}, cubes max abs err {err:.3e}')
    return n_dep


def phase2_atmosphere(dev, res):
    """The atmospheres and the illuminations against the plain versions at
    B = B_MAIN: on star_planet_a090.in as written (the slice's main path:
    101^3, masked core, 1-D density, temperature and velocity profiles,
    stellar illumination, line_prof_file, one observer in the xy plane) K2's
    illumination instance with the limb record, K5's atmosphere 2 with FFS
    lanes, K7's mask walk (direct, resonance) and PEEL_STELLAR in the
    namelist's orientation and with the observer on +z; K2's point instance
    with line_prof_file on that grid; on wasp52b_like.in as written (65^3,
    tau 1e4) K2 stellar with a Voigt spectrum, K5 and PEEL_STELLAR on +z,
    and plane_illumination's disk; the plane atmosphere (1 x 1 x 201, tau
    1e3) lit by plane_illumination (K2, K5's atmosphere 1) and its 1-D
    emissivity profile (K2's alias instance); point_illumination on a
    65 x 65 x 33 box; stellar illumination on the AMR sphere of
    make_amr_sphere(32, 1) and on clumps_overlap.in (K2 and PEEL_STELLAR
    with amr_find_cell and clump_find)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport.engine import make_chunk
    seed = 1300
    over = dict(batch_size=B_MAIN)
    plus_z = dict(obsx=(0.0,), obsy=(0.0,), obsz=(1e5,), alpha=(0.0,),
                  beta=(0.0,), nobs=1)

    # the main path's grid
    t0 = time.time()
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        'a090', ROOT, **over), dev)
    assert meta.atmosphere == 2 and not meta.static_medium
    assert ch.refill_params.kernel == 'refill_illum'
    log(2, f'star_planet_a090.in as written: {meta.nx}^3, '
           f'{int(grid.mask.sum())} masked core cells, T from '
           f'{float(grid.Dfreq.min()):.4e} to {float(grid.Dfreq.max()):.4e} '
           f'Hz Doppler widths, line profile {ch.refill_params.lp.n} bins '
           f'(set-up {time.time() - t0:.1f} s)')
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'a090 as written: stellar, '
                       'line_prof_file, limb record')
    for s in range(2):
        seed += 10
        _, _, frac, err, tal = both(
            meta, seed, fly_step(ch), ('Jout', 'Jmu', 'W_oor', 'Jabs2'), dev,
            r_max=10.0 if s == 0 else 1.0, tallies=ch.zero_tallies)
        _max_err(res, 'fly_cartesian' + ATM, err)
        log(2, f'K5 fly_cartesian, a090 atmosphere 2 (moving, per-cell T, '
               f'lanes within r < {10.0 if s == 0 else 1.0}): lanes '
               f'differing {frac:.2e}, max abs err {err:.3e}; tallies max '
               f'|d| {tal}')
    for label, mode in (('direct', tpeel.DIRECT),
                        ('resonance', tpeel.RESONANCE)):
        seed += 10
        n_bad, n_dep, err, dtau, dw = peel_both(ch, meta, seed, mode, dev,
                                                r_max=1.0)
        _max_err(res, 'peel' + STELLAR_K, err)
        log(2, f'K7 peel {label}, a090 mask walk: {n_dep} pairs deposit, '
               f'pairs differing {n_bad}, max |d tau| {dtau:.3e}, per-pair '
               f'deposits max rel err {dw:.3e}, cubes max abs err {err:.3e}')
    seed += 10
    n_xy = stellar_case(ch, meta, dev, seed, res, 'a090 as written, its '
                        'observer at alpha 90 beta 90', min_dep=0.0)
    c2 = testing.source_params('a090', ROOT, **over, **plus_z,
                               save_direc0=True).resolve()
    ch2 = make_chunk(c2, meta, grid)
    seed += 10
    n_z = stellar_case(ch2, meta, dev, seed, res, 'a090 with its observer on '
                       '+z, Direct0', key='peel' + STELLAR_Z)
    log(2, f'PEEL_STELLAR in-image pairs on a090: {n_xy} in the namelist\'s '
           f'orientation, {n_z} on +z, of {B_MAIN}')
    c3 = testing.source_params('a090', ROOT, **over,
                               source_geometry='point').resolve()
    ch3 = make_chunk(c3, meta, grid)
    assert ch3.refill_params.kernel == 'refill_point'
    seed += 10
    refill_with_record(ch3, meta, dev, seed, res, 'a point source with '
                       'line_prof_file on the a090 grid')
    del ch, ch2, ch3, grid

    # wasp52b_like.in as written
    cfg, meta, grid, ch = sources_chunk(testing.source_params(
        'wasp52b', ROOT, **over), dev)
    assert meta.atmosphere == 2 and meta.static_medium
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'wasp52b as written: '
                       'stellar, Voigt, no peel')
    seed += 10
    _, _, frac, err, tal = both(meta, seed, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor', 'Jabs2'), dev,
                                r_max=1.0, tallies=ch.zero_tallies)
    _max_err(res, 'fly_cartesian' + ATM, err)
    log(2, f'K5 fly_cartesian, wasp52b atmosphere 2 (tau 1e4, '
           f'{int(grid.mask.sum())} masked cells): lanes differing '
           f'{frac:.2e}, max abs err {err:.3e}; tallies max |d| {tal}')
    c2 = testing.source_params('wasp52b', ROOT, **over, **plus_z,
                               save_peeloff=True, save_direc0=True,
                               nxim=65, nyim=65).resolve()
    ch2 = make_chunk(c2, meta, grid)
    seed += 10
    # the image spans the box, 1.2% of the disk of the star behind it
    stellar_case(ch2, meta, dev, seed, res, 'wasp52b with an observer on '
                 '+z, Direct0', min_dep=0.005)
    seed += 10
    n_bad, n_dep, err, dtau, dw = peel_both(ch2, meta, seed, tpeel.RESONANCE,
                                            dev, r_max=1.0)
    _max_err(res, 'peel' + STELLAR_K, err)
    log(2, f'K7 peel resonance, wasp52b mask walk at tau 1e4: {n_dep} pairs '
           f'deposit, pairs differing {n_bad}, max |d tau| {dtau:.3e}, '
           f'cubes max abs err {err:.3e}')
    c3 = testing.source_params('wasp52b', ROOT, **over,
                               source_geometry='plane_illumination'
                               ).resolve()
    seed += 10
    refill_with_record(make_chunk(c3, meta, grid), meta, dev, seed, res,
                       'plane_illumination\'s disk on the wasp52b grid')
    del ch, ch2, grid

    # the plane atmosphere: plane_illumination, atmosphere 1, the profile
    par = testing.plane_atmosphere_params(nz=201, **over)
    cfg, meta, grid, ch = sources_chunk(par, dev)
    assert meta.atmosphere == 1
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'plane_illumination on a '
                       '1x1x201 plane atmosphere')
    seed += 10
    _, _, frac, err, tal = both(meta, seed, fly_step(ch),
                                ('Jout', 'Jmu', 'W_oor', 'Jabs2'), dev,
                                tallies=ch.zero_tallies)
    _max_err(res, 'fly_cartesian' + ATM, err)
    log(2, f'K5 fly_cartesian, plane atmosphere 1 (1x1x201, tau 1e3, the '
           f'bottom face destroys): lanes differing {frac:.2e}, max abs err '
           f'{err:.3e}; tallies max |d| {tal}')
    prof = str(ROOT / 'examples/star_planet/dens_profile.txt')
    _, m2, g2, ch2 = sources_chunk(testing.plane_atmosphere_params(
        nz=201, **over, source_geometry='diffuse_emissivity',
        emiss_file=prof, zmax=10.0), dev)
    assert ch2.refill_params.kernel == 'refill_alias'
    seed += 10
    refill_with_record(ch2, m2, dev, seed, res,
                       'a 1-D emissivity profile in a plane atmosphere')
    del ch, grid, ch2, g2

    # point_illumination on a box
    from lart_tpu_torch.config import Params
    par = Params(nphotons=10 ** 6, geometry='', nx=65, ny=65, nz=33, xmax=1,
                 ymax=1, zmax=0.2, tauhomo=0.5, temperature=1e4,
                 xfreq_min=-20.0, xfreq_max=20.0,
                 source_geometry='point_illumination', zs_point=-5.0,
                 spectral_type='voigt', **over)
    cfg, meta, grid, ch = sources_chunk(par, dev)
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'point_illumination below '
                       'a 65x65x33 box')
    del ch, grid

    # the AMR sphere and the clumps lit by the star, observed on +z
    star = dict(source_geometry='stellar_illumination', stellar_radius=2.0,
                distance_star_to_planet=50.0, stellar_limb_darkening=1,
                save_peeloff=True, save_direc0=True, nxim=33, nyim=33,
                **plus_z, **over)
    meta, ch, _, _ = amr_chunk(testing.amr_params(32, 1, tau0=50.0,
                                                  **star),
                               amr_leaves('sphere48k'), dev)
    amr = ch.flight.amr

    def amr_state(s):
        return testing.amr_state(meta, amr, B_MAIN, s, dev)
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'stellar on the AMR '
                       'sphere (amr_find_cell)', state=amr_state(seed + 1))
    seed += 10
    stellar_case(ch, meta, dev, seed, res, 'the AMR sphere, amr_find_cell '
                 'entry', state_fn=amr_state)
    del ch
    meta, ch, _ = clump_chunk(clump_params('overlap', **star), dev)
    cl = ch.flight.clump

    def clump_state(s):
        return testing.clump_state(meta, cl, B_MAIN, s, dev)
    seed += 10
    refill_with_record(ch, meta, dev, seed, res, 'stellar on '
                       'clumps_overlap.in (clump_find)',
                       state=clump_state(seed + 1))
    seed += 10
    stellar_case(ch, meta, dev, seed, res, 'clumps_overlap.in, the clump '
                 'sightline', state_fn=clump_state)
    del ch


def a090_transit_namelist(tmp, photons=None):
    """star_planet_a090.in with its observer on +z (beta(1) = 0, behind
    the planet) and save_direc0, its files made absolute, FITS."""
    from lart_tpu_torch import testing
    rel = testing.SOURCE_CASES['a090'][0]
    src = ROOT / 'examples' / rel
    text = re.sub(r'(?m)^\s*par%beta\(1\)\s*=.*$', ' par%beta(1) = 0.0',
                  src.read_text())
    keys = {k: f"'{v}'" for k, v in testing.source_files(src).items()}
    keys.update(save_direc0='.true.', save_peeloff_3D='.true.')
    if photons:
        keys['no_photons'] = f'{photons:g}'
    return namelist_variant('star_planet/a090_transit.in', tmp, text=text,
                            **keys)


def atm_agree(name, res, cpu):
    """<N_scatt>, the Jabs2 share and the normalized flux factor of the
    port's run against lart_tpu's CPU run: each within 5% or 3 sigma of
    the photon spread, sigma = one photon's spread (the CPU runs'; for the
    share at least its binomial sqrt(p (1 - p)), which four runs' spread
    may underestimate) times sqrt(1 / n_card + 1 / n_cpu)."""
    from lart_tpu_torch import testing
    b = testing.atmosphere_budget(res)
    n1, n2 = res.nphotons, cpu['photons']
    out = []
    for key, got in (('N', b['N']), ('share', b['share']),
                     ('ff', res.flux_factor)):
        want = cpu[key]
        pp = cpu[key + '_pp']
        if key == 'share':
            pp = max(pp, math.sqrt(want * (1.0 - want)))
        sig = pp * math.sqrt(1.0 / n1 + 1.0 / n2)
        ok = abs(got - want) <= max(0.05 * abs(want), 3.0 * sig)
        assert ok, (name, key, got, want, sig)
        out.append(f'{key} {got:.6e} vs {want:.6e} (3 sigma {3 * sig:.2e})')
    return ', '.join(out)


def atmosphere_cli(tmp, device, total):
    """The atmospheres through the CLI, FITS written and read back:
    star_planet_a090.in as written (the main path; W_esc + W_abs2 + W_oor
    against the birth weights summed on the device, <N_scatt>, the Jabs2
    share and the normalized flux factor against lart_tpu's CPU run),
    wasp52b_like.in as written, a090 with its observer on +z and Direct0
    (Direct <= Direct0 in every bin, the transit depth against lart_tpu's)
    and the plane atmosphere (1 x 1 x 32, tau 1e3) lit by
    plane_illumination.  Each run's launches go into total['atmosphere']
    [name]."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum
    sub = total.setdefault('atmosphere', {})

    def run(name, nml, need, cpu_key):
        out = Path(tmp) / f'{name}.fits'
        with birth_tally() as born:
            rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        spec = read_spectrum(str(out))
        jout = np.asarray(spec['Jout'], np.float64)
        assert np.all(np.isfinite(jout)) and 'Jabs2' in spec
        w_birth = float(torch.stack(born).sum()) / res.nphotons
        b = testing.atmosphere_budget(res)
        assert abs(b['total'] - w_birth) < 1e-3, (name, b, w_birth)
        msg = (f'W_esc {b["W_esc"]:.6f} + W_abs2 {b["W_abs2"]:.6f} + W_oor '
               f'{b["W_oor"]:.6f} = {b["total"]:.6f} against the birth '
               f'weights {w_birth:.6f}; ' + atm_agree(
                   name, res, ATM_CPU[cpu_key]))
        if res.flux_factor:
            assert float(spec['flux_factor']) == res.flux_factor
        add_launches(total, launches, need)
        sub[name] = launches
        return res, msg, wall, launches

    path = ('refill_illum', 'fly_cartesian', 'scatter_lya')
    # star_planet_a090.in as written: the main path
    res, msg, wall, launches = run('a090', source_variant('a090', tmp),
                                   path + ('peel_stellar', 'peel'), 'a090')
    log(4, f'CLI star_planet_a090.in as written ({res.nphotons} photons, '
           f'101^3, masked core, line_prof_file, stellar peel, FITS): {msg}; '
           f'normalized flux factor {res.flux_factor:.6e}, nrejected '
           f'{res.nrejected:.0f}; wall {wall:.1f} s; launches {launches}')
    # wasp52b_like.in as written
    res, msg, wall, launches = run('wasp52b', source_variant('wasp52b', tmp),
                                   path, 'wasp52b')
    log(4, f'CLI wasp52b_like.in as written ({res.nphotons} photons, 65^3, '
           f'tau 1e4, FITS): {msg}; wall {wall:.1f} s; launches {launches}')
    # a090 on +z with Direct0: the transit
    nml = a090_transit_namelist(tmp)
    res, msg, wall, launches = run('a090_transit', nml,
                                   path + ('peel_stellar',), 'a090_transit')
    with open_read(str(Path(tmp) / 'a090_transit_peel3D.fits')) as f:
        d1 = np.asarray(f['Direct/data'], np.float64)
        d0 = np.asarray(f['Direct0/data'], np.float64)
    assert d0.sum() > 0 and np.all(d1 <= d0 * (1 + 1e-6))
    depth, sig, n_in = testing.transit(res)
    cpu = ATM_CPU['a090_transit']
    cpu_sig = cpu['depth_pp'] / math.sqrt(cpu['photons'])
    assert abs(depth - cpu['depth']) <= 3.0 * math.hypot(sig, cpu_sig), \
        (depth, sig, cpu)
    log(4, f'CLI a090 with its observer on +z and Direct0 ({res.nphotons} '
           f'photons): {msg}; Direct <= Direct0 (1 + 1e-6) in every bin, '
           f'transit depth {depth:.6f} +- {sig:.6f} ({n_in:.0f} pairs in the '
           f'image) vs lart_tpu {cpu["depth"]:.6f} +- {cpu_sig:.6f}; wall '
           f'{wall:.1f} s; launches {launches}')
    # the plane atmosphere lit by plane_illumination
    par = testing.plane_atmosphere_params(
        nphotons=ATM_CPU['plane']['photons'], file_format='fits')
    nml = testing.write_namelist(Path(tmp) / 'plane.in', par, (
        'nphotons', 'geometry', 'nx', 'ny', 'nz', 'xmax', 'ymax', 'zmax',
        'taumax', 'temperature', 'xfreq_min', 'xfreq_max',
        'source_geometry', 'spectral_type', 'batch_size', 'chunk_cycles',
        'save_Jin', 'file_format'))
    res, msg, wall, launches = run('plane', nml, path, 'plane')
    log(4, f'CLI a plane atmosphere (1x1x32, tau 1e3) lit by '
           f'plane_illumination ({res.nphotons} photons): {msg}; <N_scatt> '
           f'{res.nscatt_gas:.2f}; wall {wall:.1f} s; launches {launches}')


def atm_window(label, par, dev, min_s=WINDOW_S):
    """rate_window with the photons launched a second beside the gas
    scatterings: 3 warm-up chunks, then whole chunks for at least min_s
    seconds.  Returns the prepared run."""
    from lart_tpu_torch import driver
    t0 = time.time()
    p = driver.prepare(par, seed=12345, device=dev)
    t_prep = time.time() - t0
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    card = smi()
    torch.cuda.synchronize()
    l0 = int(p.state.n_launched[0])
    t0 = time.perf_counter()
    nsc, n = 0.0, 0
    while True:
        h = driver.chunk_to_host(*p.run_chunk())
        nsc += h['nscatt_gas']
        n += 1
        if time.perf_counter() - t0 >= min_s:
            break
    dt = time.perf_counter() - t0
    cycles = n * par.chunk_cycles
    log(5, f'{label} photons: {h["launched"] - l0} launched in {dt:.6f} s = '
           f'{(h["launched"] - l0) / dt:.6e} photons/s [{card}]')
    log(5, f'{label} B={par.batch_size} (set-up {t_prep:.1f} s): {nsc:.6e} '
           f'gas scatterings (weighted) in {dt:.6f} s over {n} chunks x '
           f'{par.chunk_cycles} cycles = {nsc / dt:.6e} scatterings/s, '
           f'{dt / cycles * 1e6:.3f} us a cycle [{card}]')
    return p


def stellar_times(p, card, label, res, key=None, reps=10):
    """K7's PEEL_STELLAR on one refill's newborns of the prepared run
    (their record as K2 writes it), against its plain version and its
    bound, with the pairs in the image (the plain version's stats); the
    times go into res[key] where key is given."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.instruments import peel as tpeel
    from lart_tpu_torch.transport import refill
    ch = p.chunk
    tl = ch.zero_tallies(p.device)
    rec = tpeel.PeelRecord.zeros(p.state.batch, p.device)
    st = testing.clone_state(p.state)
    st.phase.zero_()        # every lane reborn: a refill's worth of pairs
    refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, 10 ** 9, rec)
    cubes = ch.peel.zero_cubes(p.device)
    stats = {'lanes': int((rec.flag != 0).sum()), 'mode': tpeel.STELLAR}
    tpeel.peel_plain(st, cubes, rec, ch.peel, tpeel.STELLAR, stats=stats)

    def kern():
        tpeel.peel(st, cubes, rec, ch.peel, tpeel.STELLAR)

    def plain():
        tpeel.peel_plain(st, cubes, rec, ch.peel, tpeel.STELLAR)
    ms = device_ms([kern] * reps)
    call_ms, plain_ms = turns(kern, plain, reps, plain_reps=2)
    bnd = bound(*kernel_work('peel', st, ch, p.meta, stats))
    if key:
        res.setdefault(key, {}).update(
            ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
    log(5, f'{label} peel stellar at B={st.batch} ({stats["lanes"]} newborns,'
           f' {stats["seen"]} pairs in the image and the band, '
           f'{stats["crossing"]} of them crossing the atmosphere, '
           f'{stats.get("crossings", 0)} cell crossings over '
           f'{stats["cells"]} distinct cells): kernel {ms:.6f} ms on the '
           f'device, {call_ms:.6f} ms a call; plain {plain_ms:.6f} ms a call;'
           f' bound {bnd[0]:.6f} ms ({bnd[1]}) [{card}]')
    return stats


def atmosphere_phase5(dev, res):
    """Two windows: star_planet_a090.in as written (the main path; its
    budget raised to 1e9 photons so the window sees no drain) and
    wasp52b_like.in as written, each with photons/s and gas
    scatterings/s, the profile, and the kernel times of K2's illumination
    instance, K5 with its atmosphere and K7's PEEL_STELLAR (its in-image
    pairs; wasp52b with an observer added on +z) against their plain
    versions and bounds; the a090 numbers, as written and on +z, go into
    the kernels line."""
    from lart_tpu_torch import testing
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    p = atm_window('star_planet_a090.in as written (101^3, masked core, '
                   'line_prof_file, stellar peel, 129x129 x 101)',
                   testing.source_params('a090', ROOT, **over), dev)
    card = smi()
    profile_chunks(p, card, 'a090', split_peel=True)
    kernel_times(p, card, 'a090', res, ('refill_illum', 'fly_cartesian'),
                 record=('refill_illum', ('fly_cartesian', ATM)))
    stellar_times(p, card, 'a090 (observer at alpha 90, beta 90)', res,
                  'peel' + STELLAR_K)
    del p
    p = atm_window('star_planet_a090.in with its observer on +z and '
                   'Direct0', testing.source_params(
                       'a090', ROOT, **over, beta=(0.0,), save_direc0=True),
                   dev, min_s=0.2)
    stellar_times(p, smi(), 'a090 on +z', res, 'peel' + STELLAR_Z)
    del p
    p = atm_window('wasp52b_like.in as written (65^3, tau 1e4, masked '
                   'core, Voigt)',
                   testing.source_params('wasp52b', ROOT, **over), dev)
    card = smi()
    profile_chunks(p, card, 'wasp52b')
    kernel_times(p, card, 'wasp52b', res, ('refill_illum', 'fly_cartesian',
                                           'scatter_lya'))
    del p
    p = atm_window('wasp52b_like.in with an observer on +z and Direct0',
                   testing.source_params(
                       'wasp52b', ROOT, **over, save_peeloff=True,
                       save_direc0=True, nxim=65, nyim=65, obsx=(0.0,),
                       obsy=(0.0,), obsz=(1e5,), nobs=1), dev, min_s=0.2)
    stellar_times(p, smi(), 'wasp52b on +z', {})
    del p


# ---------------------------------------------------------------------------
# the shearing box and the CALCJ/CALCP/CALCPnew maps
# ---------------------------------------------------------------------------

# the slice's main path, the maps' flags, the names of its K5 and K4
# instances in res, and lart_tpu's CPU figures (tools/shear_cpu_runs.py)
SHEAR_IN = 'tigress_shear/shear.in'
JPA_ON = dict(calcJ=True, calcP=True, calcPnew=True)
SHEAR_K, DEPOSITS, PA = ' (shear)', ' (J1, Pnew)', ' (Pa)'
# K4's Jabs on a hot dusty state (jabs_hot): phase 2's error alone, since
# the dusty instances' times and launches are K4's own entry's
JABS = ' (Jabs)'
MAP_REL = 1e-5           # a kernel's map against its plain version's, of
#                          the largest bin: atomics add in another order
SHEAR_CPU = ROOT / 'tools' / 'shear_cpu_runs.json'
# phase 4's cuts of the maps' examples (tools/shear_cpu_runs.py CUTS) and
# their photons on the card
MAP_CUTS = {'slab': ('slab/t1tau6.in', dict(tauhomo='1e4'), SLAB_PHOTONS),
            'sphere': ('sphere/t4tau7.in', dict(taumax='1e3'), 2e4)}


def maps_agree(tk, tp, fields):
    """{map: max |kernel - plain| over its largest bin}, each within
    MAP_REL."""
    out = {}
    for f in fields:
        u, v = getattr(tk, f), getattr(tp, f)
        top = float(v.abs().max())
        assert top > 0.0, f
        out[f] = float((u - v).abs().max()) / top
        assert out[f] <= MAP_REL, (f, out[f])
    return out


def jpa_grids(dev):
    """The three binning geometries at the card's size, one at a time:
    t1tau6.in as written (1 x 1 x 129, the z cell), t4tau7.in as written
    (129^3, radial), a 65^3 uniform box without rmax (the flat cell, whose
    274625 bins exceed the block copies' BLOCK_COPY_BYTES: the warp level
    alone), each with the three maps, t4tau7.in with calcP alone (K6 and
    K4's sphere fast path), and testing.jpa_params' 1 x 1 x 33 slab with
    80 frequency bins, whose J1 fits a block copy: (label, meta, chunk,
    r_max)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.transport.engine import make_chunk
    for label, par, r_max in (
            ('t1tau6 as written', example_params(
                'slab/t1tau6.in', batch_size=B_MAIN, **JPA_ON), None),
            ('t4tau7 as written', example_params(
                'sphere/t4tau7.in', batch_size=B_MAIN, **JPA_ON), 1.0),
            ('a 65^3 box', testing.jpa_params(
                'box', tau0=1e3, batch=B_MAIN, nx=65, ny=65, nz=65), None),
            ('t4tau7 with calcP alone', example_params(
                'sphere/t4tau7.in', batch_size=B_MAIN, calcP=True), 1.0),
            ('a 1x1x33 slab, 80 frequency bins', testing.jpa_params(
                'slab', tau0=1e4, batch=B_MAIN), None)):
        cfg = par.resolve()
        meta, grid = build_cartesian(cfg, device=dev)
        yield label, meta, make_chunk(cfg, meta, grid), r_max


def deposit_paths(ch, dev):
    """The path each map's deposits take in a launch of the chunk's K5 and
    K4 (the wrappers' block plans, transport/jpa.py block_plan): {map:
    'block copy of n bins' or 'warp level'}."""
    from lart_tpu_torch.transport import fly_cartesian as tfc
    from lart_tpu_torch.transport import scatter
    tl = ch.zero_tallies(dev)
    plan = []
    if isinstance(ch.flight, tfc.CartesianFlight) and ch.flight.jpa:
        plan += zip(('Pnew', 'J1'), tfc.deposit_plan(ch.flight, tl))
    if ch.scatter_params.jpa is not None:
        plan.append(('Pa', scatter.deposit_plan(ch.scatter_params, tl)))
    return {k: f'block copy of {n} bins' if n else 'warp level'
            for k, n in plan if getattr(tl, k) is not None}


def hot_bins(label, meta, ch, r_max, dev, res, seed):
    """The hot-bin cases of one grid of jpa_grids: every lane in the
    centre cell (a centred point source's: the slab's z cell, the sphere's
    central radial bin) through K5's J1 and Pnew deposits and K4's Pa, and
    with J1 on every lane also in one frequency bin through K5; lanes at 0
    differing and each map within MAP_REL of its largest bin, with the
    path each map took (deposit_paths)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
    paths = deposit_paths(ch, dev)
    k5 = isinstance(ch.flight, CartesianFlight) and ch.flight.jpa
    xc = meta.xfreq_min + (meta.nxfreq // 2 + 0.5) * meta.dxfreq
    cases = [('every lane in the centre cell', None)]
    if k5 and ch.jpa[0]:
        cases.append(('every lane in the centre cell and one frequency bin',
                      xc))
    for what, xf in cases:
        seed += 10
        s0 = testing.hot_state(meta, B_MAIN, seed, dev, xfreq=xf)
        d = {}
        if k5:
            out = {}
            _, _, frac, err, _ = both(meta, seed, fly_step(ch),
                                      ('Jout', 'Jmu', 'W_oor'), dev,
                                      r_max=r_max, state=s0,
                                      tallies=ch.zero_tallies, out=out)
            assert frac == 0.0, frac
            d.update(maps_agree(out[True], out[False], [
                f for f in ('J1', 'Pnew') if getattr(out[False], f)
                is not None]))
            _max_err(res, 'fly_cartesian' + DEPOSITS, err)
        if xf is None:
            out = {}
            _, _, frac, err, _ = both(meta, seed, scatter_step(ch),
                                      ('nscatt_gas', 'nscatt_events'), dev,
                                      r_max=r_max, state=s0,
                                      tallies=ch.zero_tallies, out=out)
            assert frac == 0.0, frac
            d.update(maps_agree(out[True], out[False], ('Pa',)))
            _max_err(res, 'scatter_lya' + PA, err)
        log(2, f'hot bins, {label}, {what}: paths {paths}; lanes differing '
               f'0; maps max |d| over their largest bin '
               f'{ {k: float(f"{v:.3e}") for k, v in d.items()} }')
    return seed


def jabs_hot(dev, res, seed):
    """K4's Jabs deposit on DL20e_dust.in as written (the 201^3 shell,
    outflow 200 km/s, Mueller dust) with calcP, whose kMaps instance adds
    Pa through the aggregated path and Jabs by one f32 atomic an
    absorption: every lane in the shell's densest dust cell at x = 20,
    where ~1 event in 10 is dust (tau_HI(20) ~ 4 beside the dust's ~0.5)
    and the absorptions' lab frequencies x + u.k fall on a few dozen bins;
    lanes at 0 differing, Jabs and Pa within MAP_REL of their largest bin,
    with Pa's path; the lanes' error under the key of its own 'scatter_lya
    (Jabs)'."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.transport.engine import make_chunk
    t0 = time.time()
    cfg = example_params(DL20E_DUST, batch_size=B_MAIN, calcP=True).resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    cell = np.unravel_index(int(torch.argmax(grid.rhokapD.reshape(-1))),
                            (meta.nx, meta.ny, meta.nz))
    s0 = testing.hot_state(meta, B_MAIN, seed, dev, cell=cell, xfreq=20.0)
    out = {}
    _, _, frac, err, _ = both(meta, seed, scatter_step(ch),
                              ('nscatt_gas', 'nscatt_events', 'nscatt_dust'),
                              dev, state=s0, tallies=ch.zero_tallies, out=out)
    assert frac == 0.0, frac
    d = maps_agree(out[True], out[False], ('Jabs', 'Pa'))
    _max_err(res, 'scatter_lya' + JABS, err)
    log(2, f'hot bins, K4 scatter_lya\'s Jabs on DL20e_dust as written, '
           f'every lane in cell {tuple(int(c) for c in cell)} at x = 20: '
           f'paths '
           f'{deposit_paths(ch, dev)}; {int((out[False].Jabs != 0).sum())} '
           f'bins absorbed into, lanes differing 0, max abs err {err:.3e}, '
           f'max |d| over the largest bin: Jabs {d["Jabs"]:.3e}, Pa '
           f'{d["Pa"]:.3e} ({time.time() - t0:.1f} s)')


def phase2_hot_bins(dev, res):
    """The hot-bin cases alone (hot_bins on each grid of jpa_grids, then
    jabs_hot), as phase2_shear runs them."""
    seed = 1700
    for label, meta, ch, r_max in jpa_grids(dev):
        seed = hot_bins(label, meta, ch, r_max, dev, res, seed)
        del ch
    jabs_hot(dev, res, seed + 10)


def phase2_shear(dev, res):
    """The shearing box and the maps against the plain versions at B =
    B_MAIN: K5's shear wrap on shear.in as written (the slice's main path,
    32 x 32 x 64, omega_shear 2.2; lanes next to both x faces with a
    shear-frame velocity each) and K2's unsheared births there; K5's J1
    and Pnew deposits and K4's Pa deposit in the three geometries
    (jpa_grids), lanes at 0 differing and the maps within MAP_REL of their
    largest bin, then the grid's hot-bin cases (hot_bins) and K4's Jabs
    on DL20e_dust (jabs_hot); and one 32-cycle chunk against its cycles
    one at a time with the atomics' f64 maps (tests/test_torch_precision.py's
    sphere at B = B_MAIN): the states bitwise equal, the worst bin
    printed."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.config import Params
    from lart_tpu_torch.grid.cartesian import build_cartesian
    from lart_tpu_torch.transport.engine import make_chunk
    from lart_tpu_torch.transport.fly_cartesian import CartesianFlight
    from lart_tpu_torch.transport.state import DEAD, LANE_FIELDS
    seed = 1400
    t0 = time.time()
    cfg = example_params(SHEAR_IN, batch_size=B_MAIN).resolve()
    meta, grid = build_cartesian(cfg, device=dev)
    ch = make_chunk(cfg, meta, grid)
    om = meta.omega_shear
    assert isinstance(ch.flight, CartesianFlight) and om > 0.0
    log(2, f'shear.in as written: {meta.nx}x{meta.ny}x{meta.nz}, '
           f'omega_shear {om:.6f} (set-up {time.time() - t0:.1f} s)')
    for _ in range(2):
        seed += 10
        s0 = testing.shear_state(meta, B_MAIN, seed, dev)
        _, sk, frac, err, tal = both(meta, seed, fly_step(ch),
                                     ('Jout', 'Jmu', 'W_oor'), dev, state=s0,
                                     tallies=ch.zero_tallies)
        assert frac == 0.0, frac
        moved = sk.vfy_shear - s0.vfy_shear
        up, down = int((moved > 0.5 * om).sum()), int((moved < -0.5 * om)
                                                      .sum())
        assert up > 0 and down > 0, (up, down)
        _max_err(res, 'fly_cartesian' + SHEAR_K, err)
        log(2, f'K5 fly_cartesian with the shear wrap, shear.in as written '
               f'(moving, lanes next to both x faces): {up} lanes wrapped '
               f'+x, {down} -x, lanes differing {frac:.2e}, max abs err '
               f'{err:.3e}; tallies max |d| {tal}')
    seed += 10
    s0 = testing.shear_state(meta, B_MAIN, seed, dev)
    _, sk, frac, err, tal = both(meta, seed, refill_step(ch), ('Jin',), dev,
                                 state=s0, tallies=ch.zero_tallies)
    born = (s0.phase == DEAD) & (sk.phase != DEAD)
    assert frac == 0.0 and int(born.sum()) > 0
    assert float(sk.vfy_shear[born].abs().max()) == 0.0
    _max_err(res, 'refill_point', err)
    log(2, f'K2 refill_point on shear.in: {int(born.sum())} births, each '
           f'unsheared; lanes differing {frac:.2e}, max abs err {err:.3e}')
    del grid, ch

    for label, meta, ch, r_max in jpa_grids(dev):
        seed += 10
        geo = f'{label} (geometry_JPa {meta.geometry_JPa}, {meta.nbin_JPa} ' \
              f'bins)'
        if ch.jpa[0]:
            out = {}
            _, _, frac, err, tal = both(meta, seed, fly_step(ch),
                                        ('Jout', 'Jmu', 'W_oor'), dev,
                                        r_max=r_max, tallies=ch.zero_tallies,
                                        out=out)
            assert frac == 0.0, frac
            d = maps_agree(out[True], out[False], ('J1', 'Pnew'))
            _max_err(res, 'fly_cartesian' + DEPOSITS, err)
            log(2, f'K5 fly_cartesian with the J1 and Pnew deposits, {geo}: '
                   f'lanes differing {frac:.2e}, max abs err {err:.3e}; maps '
                   f'max |d| over their largest bin {d}')
        else:
            assert type(ch.flight).__name__ == 'SphereFlight'
        seed += 10
        out = {}
        _, _, frac, err, tal = both(meta, seed, scatter_step(ch),
                                    ('nscatt_gas', 'nscatt_events'), dev,
                                    r_max=r_max, tallies=ch.zero_tallies,
                                    out=out)
        assert frac == 0.0, frac
        d = maps_agree(out[True], out[False], ('Pa',))
        _max_err(res, 'scatter_lya' + PA, err)
        log(2, f'K4 scatter_lya with the Pa deposit, {geo}'
               f'{" (rk_const " + str(ch.scatter_params.rk_const) + ")" if ch.scatter_params.rk_const > 0 else ""}: '
               f'lanes differing {frac:.2e}, max abs err {err:.3e}; Pa max '
               f'|d| over its largest bin {d["Pa"]:.3e}')
        seed = hot_bins(label, meta, ch, r_max, dev, res, seed)
        del ch
    jabs_hot(dev, res, seed + 10)

    # the f64 maps of one chunk against its cycles flushed one at a time
    par = Params(nphotons=1 << 30, geometry='sphere', rmax=1.0, nx=33, ny=33,
                 nz=33, taumax=1e4, temperature=1e4, core_skip=True,
                 xfreq_min=-40.0, xfreq_max=40.0, nxfreq=129,
                 batch_size=B_MAIN, fly_substeps=8, scatter_rounds=4,
                 chunk_cycles=32, refill_every=4, **JPA_ON)
    t0 = time.time()
    s1, prod, s2, acc = testing.chunk_vs_cycles(par, device=dev)
    for f in LANE_FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    worst = {}
    for k in ('Jin', 'J1', 'Pa', 'Pnew', 'Jout'):
        a, b = prod[k], acc[k]
        if not b.any():
            continue
        tot = abs(a.sum() - b.sum()) / b.sum()
        worst[k] = float(np.abs(a - b).max() / b.max())
        assert tot < 2e-5 and worst[k] < 5e-5, (k, tot, worst[k])
    assert {'Jin', 'J1', 'Pa', 'Pnew'} <= set(worst), worst
    log(2, f'one 32-cycle chunk against its cycles flushed one at a time '
           f'(33^3 sphere, tau 1e4, core-skip, the three maps, B={B_MAIN}):'
           f' states bitwise equal; worst bin over the largest {worst} '
           f'({time.time() - t0:.1f} s)')


# ---------------------------------------------------------------------------
# the all-photons table (save_all_photons)
# ---------------------------------------------------------------------------

ALLPH = ' (all photons)'
ALLPH_CPU = ROOT / 'tools' / 'allph_cpu_runs.json'
# allph_cli's runs with save_all_photons (testing.SOURCE_CASES[name +
# '_allph']) and each one's flight; DL20e_dust runs in dl2008_cli,
# amr_sphere in amr_runs
ALLPH_CLI = {'t4tau7': 'fly_cartesian', 'clumps_overlap': 'fly_clump_dense',
             'bicone_clump': 'fly_clump_csr'}


def allph_tallies(ch, nrow):
    """tallies(dev) of both(): the chunk's zero tallies with a zero table
    of nrow rows of the chunk's columns (the mixed states' ids reach the
    batch size)."""
    from lart_tpu_torch.transport.allph import zero_allph
    par = ch.allph

    def make(d):
        t = ch.zero_tallies(d)
        t.allph = zero_allph(nrow, par.I is not None, par.rmax, d)
        return t
    return make


def table_diff(tk, tp):
    """(rows differing, max abs err over the others) of two tables, column
    by column at the lanes' tolerance."""
    bad = torch.zeros(tk.n, dtype=torch.bool, device=tk.rp.device)
    for f in tk.fields:
        bad |= ~torch.isclose(getattr(tk, f), getattr(tp, f), rtol=LANE_RTOL,
                              atol=LANE_ATOL)
    err = 0.0
    if bool((~bad).any()):
        err = max(float((getattr(tk, f) - getattr(tp, f)).abs()[~bad].max())
                  for f in tk.fields)
    return int(bad.sum()), err


def allph_chunk(par, dev, data=None, table=True):
    """(meta, chunk, grid) of par with save_all_photons on (table): its
    Cartesian grid, its AMR grid from the leaves `data` (grid None), or its
    clumps from iseed + 77 (grid None)."""
    par.save_all_photons = table
    if data is not None:
        meta, ch, _, _ = amr_chunk(par, data, dev)
        return meta, ch, None
    if par.use_clump_medium:
        meta, ch, _ = clump_chunk(par, dev)
        return meta, ch, None
    _, meta, grid, ch = sources_chunk(par, dev)
    return meta, ch, grid


def phase2_allph(dev, res):
    """The all-photons table against the plain versions at B = B_MAIN: the
    birth rows of K2's five instances (t4tau7.in, halo_0053.in, t4tau2.in,
    stars1.in, star_planet_a090.in; the ids compared by set, each lane's
    row at the kernel's id against the plain version's row at its own id);
    the death rows and event counts of K4's four instances with the table
    (dust absorption on DL20e_dust.in's grid with Stokes, H2 destruction
    on h2_on.in, line type 8 with dust on t4tau1e4_dust.in, line type 7
    with H2 on sphere_HD); the death rows of K5 on t4tau7.in, DL20e_dust.in
    (Stokes), shear.in and a plane atmosphere (and a090's masked core),
    each also without the table (K5's instances without kAllph); K8 on
    amr_sphere.in, K9 on clumps_overlap.in, K10 on bicone_clump.in.  Lanes
    and rows at 0 differing; each new instance's device ms with and without
    the table on the same inputs."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport.state import DEAD
    seed = 1500
    nrow = 2 * B_MAIN

    def timed(step, pre, make_t, plain_t):
        """device ms of step's kernel with the table and without it."""
        reps = 10
        out = []
        for mk in (make_t, plain_t):
            t = mk(dev)
            step(testing.clone_state(pre), t, True)   # loads the instance
            copies = [testing.clone_state(pre) for _ in range(reps)]
            out.append(device_ms([lambda s=s: step(s, t, True)
                                  for s in copies]))
            del copies
        return out

    def births(label, meta, ch):
        nonlocal seed
        seed += 2
        s0 = testing.mixed_state(meta, B_MAIN, seed, dev, r_max=1.0)
        step = refill_step(ch)
        make = allph_tallies(ch, nrow)
        sk, sp = testing.clone_state(s0), testing.clone_state(s0)
        tk, tp = make(dev), make(dev)
        step(sk, tk, True)
        step(sp, tp, False)
        torch.cuda.synchronize()
        frac, err = testing.compare_states(sk, sp, LANE_RTOL, LANE_ATOL,
                                           skip=('pid',))
        assert frac == 0.0, (label, frac)
        born = (s0.phase == DEAD) & (sk.phase != DEAD)
        n = int(born.sum())
        ik, ip = sk.pid[born].long(), sp.pid[born].long()
        want = torch.arange(n, device=dev)
        assert torch.equal(torch.sort(ik).values, want), label
        assert torch.equal(torch.sort(ip).values, want), label
        assert torch.equal(sk.pid[~born], s0.pid[~born])
        bad = torch.zeros(n, dtype=torch.bool, device=dev)
        ak, ap = tk.allph, tp.allph
        for f in ('rp0', 'xfreq1'):
            bad |= ~torch.isclose(getattr(ak, f)[ik], getattr(ap, f)[ip],
                                  rtol=LANE_RTOL, atol=LANE_ATOL)
        assert int(bad.sum()) == 0, (label, int(bad.sum()))
        assert torch.equal(ak.xfreq1[ik], sk.xfreq[born])
        assert float(sk.nsg[born].abs().sum() + sk.nsd[born].abs().sum()) == 0
        d = float((tk.Jin - tp.Jin).abs().max())
        assert d <= 1e-5 * max(float(tp.Jin.sum()), 1.0), d
        name = ch.refill_params.kernel
        _max_err(res, name + ALLPH, err)
        ms = timed(step, s0, make, ch.zero_tallies)
        bnd = bound(*kernel_work(name, s0, ch, meta))
        log(2, f'K2 {name} with the table ({label}): {n} births, ids '
               f'0..{n - 1} in both (kernel and plain version by lane: '
               f'{int((ik != ip).sum())} lanes take another id), rows '
               f'differing at their ids 0, lanes differing {frac:.2e} (pid '
               f'left out), max abs err {err:.3e}; device ms with the table '
               f'{ms[0]:.6f}, without {ms[1]:.6f}; bound {bnd[0]:.6f} ms '
               f'({bnd[1]})')

    def deaths(label, name, meta, ch, step, tal, state, expect=True):
        nonlocal seed
        seed += 2
        make = allph_tallies(ch, nrow)
        out = {}
        s0, sk, frac, err, _ = both(meta, seed, step, tal, dev, state=state,
                                    tallies=make, out=out)
        assert frac == 0.0, (label, frac)
        nd, terr = table_diff(out[True].allph, out[False].allph)
        assert nd == 0, (label, nd)
        died = (s0.phase != DEAD) & (sk.phase == DEAD)
        n_died = int(died.sum())
        assert n_died > 0 or not expect, label
        # each dead lane's row, at its id, carries its event counts
        ids = sk.pid[died].long()
        assert torch.equal(out[True].allph.nscatt_gas[ids], sk.nsg[died])
        _max_err(res, name + ALLPH, max(err, terr))
        ms = timed(step, s0, make, ch.zero_tallies)
        bnd = ''
        if name == 'scatter_lya':
            b = bound(*kernel_work(name, s0, ch, meta, {'deaths': n_died}))
            bnd = f'; bound {b[0]:.6f} ms ({b[1]})'
        log(2, f'{name} with the table ({label}): {n_died} lanes died and '
               f'wrote their rows, rows differing {nd}, lanes differing '
               f'{frac:.2e}, max abs err {max(err, terr):.3e}; device ms '
               f'with the table {ms[0]:.6f}, without {ms[1]:.6f}{bnd}')

    fly_tal = ('Jout', 'Jmu', 'W_oor')
    sc_tal = ('nscatt_gas', 'nscatt_events')
    # K2's five instances, and K5 / K4 where the grid serves them
    t0 = time.time()
    meta, ch, _ = allph_chunk(example_params('sphere/t4tau7.in',
                                          batch_size=B_MAIN), dev)
    assert type(ch.flight).__name__ == 'CartesianFlight'
    log(2, f'all photons: t4tau7.in 129^3 with the table (K5: the table '
           f'takes it off K6), set-up {time.time() - t0:.1f} s')
    births('t4tau7.in, the point source', meta, ch)
    for with_table in (True, False):
        # lanes in the whole box: the vacuum round the sphere lets them
        # escape, and forced first scatterings born there die in vacuum
        st = testing.mixed_state(meta, B_MAIN, seed + 1, dev)
        if with_table:
            deaths('t4tau7.in (kAllph)', 'fly_cartesian', meta, ch,
                   fly_step(ch), fly_tal, st)
        else:
            _, _, frac, err, _ = both(meta, seed + 1, fly_step(ch), fly_tal,
                                      dev, state=st, nmu=ch.nmu)
            assert frac == 0.0
            log(2, f'fly_cartesian without the table (t4tau7.in, its '
                   f'instance without kAllph): lanes differing {frac:.2e}')
    deaths('t4tau7.in', 'scatter_lya', meta, ch, scatter_step(ch), sc_tal,
           testing.mixed_state(meta, B_MAIN, seed + 3, dev, r_max=1.0),
           expect=False)
    del ch
    for label, par in (
            ('halo_0053.in', example_params('SSH_MUSE/halo_0053.in',
                                            batch_size=B_MAIN)),
            ('t4tau2.in', testing.source_params('t4tau2', ROOT,
                                                batch_size=B_MAIN)),
            ('stars1.in', testing.source_params('stars1', ROOT, cut=False,
                                                batch_size=B_MAIN)),
            ('star_planet_a090.in', testing.source_params(
                'a090', ROOT, batch_size=B_MAIN))):
        meta, ch, _ = allph_chunk(par, dev)
        births(label, meta, ch)
        if label == 'star_planet_a090.in':
            # the masked core and its escapes (K5 kAllph)
            deaths(f'{label}, the masked core', 'fly_cartesian', meta, ch,
                   fly_step(ch), fly_tal,
                   testing.mixed_state(meta, B_MAIN, seed + 5, dev))
        del ch

    # K5 and K4 on DL20e_dust.in as written (Stokes: the I, Q, U, V rows;
    # K4's lanes in the dusty cells, from the line core to the far wing)
    meta, ch, grid = allph_chunk(example_params(DL20E_DUST,
                                                batch_size=B_MAIN), dev)
    assert ch.allph.I is not None
    deaths('DL20e_dust.in, Stokes (kAllph)', 'fly_cartesian', meta, ch,
           fly_step(ch), fly_tal,
           testing.mixed_state(meta, B_MAIN, seed + 7, dev))
    deaths('DL20e_dust.in, dust absorption, Stokes', 'scatter_lya', meta,
           ch, scatter_step(ch), sc_tal + ('nscatt_dust', 'Jabs'),
           testing.dust_state(meta, grid, B_MAIN, seed + 9, 100.0, dev))
    del ch, grid
    # K4's other three instances with the table
    meta, ch, _ = allph_chunk(example_params(H2_ON, batch_size=B_MAIN), dev)
    sp = ch.scatter_params
    centres = [float(np.float32(d) / np.float32(sp.Dfreq)) for d in sp.h2.dnu]
    deaths('h2_on.in, H2 destruction', 'scatter_lya', meta, ch,
           scatter_step(ch), sc_tal + ('W_H2abs',),
           testing.line_state(meta, B_MAIN, seed + 11, centres + [0.0],
                              width=1.5, device=dev))
    del ch
    meta, ch, _ = allph_chunk(example_params(LYB_DUST, batch_size=B_MAIN), dev)
    st = testing.mixed_state(meta, B_MAIN, seed + 13, dev, r_max=1.0)
    testing.band2_lanes(st, 7, frac=0.35)
    deaths('t4tau1e4_dust.in, line type 8 with dust', 'scatter_lya', meta,
           ch, scatter_step(ch), sc_tal + ('Jabs', 'Jabs_Ha'), st,
           expect=False)
    del ch
    meta, ch, _ = allph_chunk(example_params(
        LINE_EXAMPLES['HD'], batch_size=B_MAIN, h2_model='neufeld',
        f_H2=0.03, h2_temperature=8000.0), dev)
    sp = ch.scatter_params
    centres = [float(np.float32(d) / np.float32(sp.Dfreq)) for d in sp.h2.dnu]
    deaths('sphere_HD with H2, line type 7', 'scatter_lya', meta, ch,
           scatter_step(ch), sc_tal + ('W_H2abs',),
           testing.line_state(meta, B_MAIN, seed + 15, centres + [0.0],
                              width=1.5, device=dev), expect=False)
    del ch
    # K5 on shear.in (its kExtra instance, with and without kAllph) and
    # a plane atmosphere (its bottom face)
    for label, par, state_fn in (
            ('shear.in', example_params(SHEAR_IN, batch_size=B_MAIN),
             testing.shear_state),
            ('a 1x1x201 plane atmosphere', testing.plane_atmosphere_params(
                nz=201, batch_size=B_MAIN), None)):
        for with_table in (True, False):
            meta, ch, grid = allph_chunk(par, dev, table=with_table)
            seed += 2
            st = state_fn(meta, B_MAIN, seed, dev) if state_fn else \
                testing.mixed_state(meta, B_MAIN, seed, dev)
            if with_table:
                deaths(f'{label} (kAllph)', 'fly_cartesian', meta, ch,
                       fly_step(ch), fly_tal, st)
            else:
                _, _, frac, err, _ = both(meta, seed, fly_step(ch), fly_tal,
                                          dev, state=st,
                                          tallies=ch.zero_tallies)
                assert frac == 0.0
                log(2, f'fly_cartesian without the table ({label}): lanes '
                       f'differing {frac:.2e}')
            del ch, grid

    # K8, K9, K10
    meta, ch, _ = allph_chunk(example_params('amr_sphere/amr_sphere.in',
                                          batch_size=B_MAIN), dev,
                           amr_leaves('sphere48k'))
    deaths('amr_sphere.in', 'fly_amr', meta, ch, fly_step(ch), fly_tal,
           testing.amr_state(meta, ch.flight.amr, B_MAIN, seed + 17, dev))
    del ch
    for label, name in (('overlap', 'fly_clump_dense'),
                        ('bicone', 'fly_clump_csr')):
        meta, ch, _ = allph_chunk(clump_params(label, batch_size=B_MAIN), dev)
        assert flight_kernel(ch) == name
        deaths(f'{label} clumps', name, meta, ch, fly_step(ch), fly_tal,
               testing.clump_state(meta, ch.flight.clump, B_MAIN,
                                   seed + 19, dev))
        del ch


def allph_check(name, res, out, wall, launches, total, fly):
    """A phase-4 run with save_all_photons: its AllPhotons section, read
    back from `out`, is the run's table; the table's closures hold
    (testing.allph_closures); where lart_tpu's CPU run of the same cut is
    recorded (tools/allph_cpu_runs.py), <nscatt_gas> agrees within 5% or 3
    sigma and the histograms of xfreq1, xfreq2 and rp by chi2/dof < 3.
    The run's launches go into total['allph'][name] (the caller adds them
    into total)."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.writer import read_spectrum
    cpu = json.loads(ALLPH_CPU.read_text())
    ap = read_spectrum(str(out))['allph']
    assert ap is not None and set(ap) == set(res.allph), name
    for k, v in ap.items():
        assert np.array_equal(v, res.allph[k].astype(np.float32)), k
    meta, n = res.meta, res.nphotons
    assert ap['rp'].shape == (n,)
    summ = testing.allph_summary(ap, testing.allph_edges(
        meta.xfreq_min, meta.xfreq_max, res.cfg.par.rmax))
    clos = testing.allph_closures(res, summ)
    for k, (v, lim) in clos.items():
        assert v <= lim, (name, k, v, lim)
    extra = ''
    if name in cpu:
        ref = cpu[name]
        sig = math.hypot(summ['N_spread'] / math.sqrt(n),
                         ref['N_spread'] / math.sqrt(ref['n']))
        dn = summ['N'] - ref['N']
        assert abs(dn) <= max(0.05 * ref['N'], 3.0 * sig), (name, dn, sig)
        chi = {k: testing.hist_chi2(summ['hist'][k], ref['hist'][k])
               for k in summ['hist']}
        for k, (c2, dof) in chi.items():
            assert dof < 1 or c2 < 3.0, (name, k, c2, dof)
        extra = (f'; lart_tpu ({ref["n"]} photons on the CPU): table '
                 f'<nscatt_gas> {ref["N"]:.4f}, |d| {abs(dn):.4f} (3 sigma '
                 f'{3 * sig:.4f}), chi2/dof ' + ', '.join(
                     f'{k} {c2:.2f} ({d})' for k, (c2, d) in chi.items()))
        if summ['sum_I'] is not None and ref.get('sum_I') is not None:
            # the forced first scatterings' escaped weight, which the rows
            # do not carry (W - sum I over the photons)
            ffs, ffs_ref = -clos['I_excess'][0], -ref['closures'][
                'I_excess'][0]
            extra += (f', W - sum I a photon {ffs:.6f} (lart_tpu '
                      f'{ffs_ref:.6f})')
    assert all(launches[k] > 0 for k in ('refill_point', fly,
                                         'scatter_lya')), launches
    total.setdefault('allph', {})[name] = launches
    log(4, f'{name} with save_all_photons ({n} photons, FITS): AllPhotons '
           f'{len(ap)} columns x {n} rows, the run\'s table; table '
           f'<nscatt_gas> {summ["N"]:.4f} (one photon\'s spread '
           f'{summ["N_spread"]:.4f}), <nscatt_dust> {summ["Nd"]:.4f}, '
           f'<N_scatt> {res.nscatt_gas:.4f}, rp q95 {summ["rp_q95"]:.4f}; '
           f'closures ' + ', '.join(f'{k} {v:.3g} (<= {lim:.3g})'
                                   for k, (v, lim) in clos.items())
           + f'{extra}, wall {wall:.1f} s; launches {launches}')


def allph_cli(tmp, device, total):
    """The all-photons table through the CLI, FITS written and read back
    (testing.SOURCE_CASES[name + '_allph']; allph_check): t4tau7.in at
    taumax 1e4 with its 1e5 photons through K5,
    clumps_overlap.in (K9) and bicone_clump.in (K10, save_clump_info off)
    as written.  DL20e_dust.in at its cut (Stokes) and amr_sphere.in run
    with the table in dl2008_cli and amr_runs."""
    for name, fly in ALLPH_CLI.items():
        out = Path(tmp) / f'{name}_allph.fits'
        rc, res, wall, launches = run_cli(
            source_variant(name + '_allph', tmp), out, device)
        assert rc == 0
        add_launches(total, launches, ('refill_point', fly, 'scatter_lya'))
        allph_check(name, res, out, wall, launches, total, fly)


ALLPH_WINDOW_PHOTONS = 10 ** 7     # the table window's budget: 240 MB


def allph_phase5(dev, res):
    """t4tau7.in as written with save_all_photons (the slice's main path:
    K5's, K2's and K4's kAllph instances, the death rows in K5's; a
    budget of ALLPH_WINDOW_PHOTONS, whose table's bytes are printed),
    then t4tau7.in as written without it (K6) in an adjacent window, and
    short windows of amr_sphere.in (K8), clumps_overlap.in (K9) and
    bicone_clump.in (K10) with the table (budgets of 1e7, 2e8, 5e7); each
    with kernel times against the plain versions and bounds, which go into
    the kernels line."""
    over = dict(batch_size=B_MAIN, chunk_cycles=32)
    p, rate = rate_window(
        f't4tau7.in as written with save_all_photons (129^3, tau 1e7, '
        f'core-skip, K5 kAllph; budget {ALLPH_WINDOW_PHOTONS:g})',
        example_params('sphere/t4tau7.in', save_all_photons=True,
                       nphotons=ALLPH_WINDOW_PHOTONS, **over), dev)
    card = smi()
    assert flight_kernel(p.chunk) == 'fly_cartesian'
    log(5, f't4tau7 with the table: {p.chunk.allph.n} rows, '
           f'{p.chunk.allph.nbytes} bytes on the device [{card}]')
    profile_chunks(p, card, 't4tau7 with the table')
    names = ('refill_point', 'fly_cartesian', 'scatter_lya')
    kernel_times(p, card, 't4tau7 with the table', res, names,
                 record=names, suffix=ALLPH)
    # K5 with the table (kAllph) and without it on the window's state, in
    # turns
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport import fly_cartesian as fcart
    ch, pre = p.chunk, testing.clone_state(p.state)
    ms = {True: [], False: []}
    for table in (True, False, False, True):
        tl = ch.zero_tallies(dev)
        tl.allph = ch.allph if table else None
        copies = [testing.clone_state(pre) for _ in range(20)]
        ms[table].append(device_ms([
            lambda s=s: fcart.fly(s, tl, ch.flight, ch.fly_substeps)
            for s in copies]))
        del copies
    log(5, f't4tau7 K5 on the window\'s state, in turns: with the table '
           f'{np.mean(ms[True]):.6f} ms, without {np.mean(ms[False]):.6f} ms '
           f'({100 * (np.mean(ms[True]) / np.mean(ms[False]) - 1):+.1f}%) '
           f'[{card}]')
    p0, _ = rate_window('t4tau7.in as written (K6, no table)',
                        example_params('sphere/t4tau7.in', nphotons=10 ** 9,
                                       **over), dev)
    # the two in turns (as written, with the table, with it, as written):
    # the host's speed drifts by ~10% from window to window
    rates = {False: [], True: []}
    for table in (False, True, True, False):
        nsc, dt, _ = window(p if table else p0, WINDOW_S)
        rates[table].append(float(nsc / dt))
    ratio = np.mean(rates[True]) / np.mean(rates[False])
    log(5, f't4tau7 with the table (K5) over as written (K6), windows in '
           f'turns: {[f"{r:.6e}" for r in rates[True]]} against '
           f'{[f"{r:.6e}" for r in rates[False]]} gas scatterings/s, '
           f'rate ratio {ratio:.4f} [{card}]')
    del p, p0
    # each window's budget holds its photons past the window (the
    # clumps_overlap photons scatter ~9 times: 4e7 die a second)
    for label, par, data, fly, budget in (
            ('amr_sphere.in with save_all_photons (48000 leaves)',
             example_params('amr_sphere/amr_sphere.in', **over),
             amr_leaves('sphere48k'), 'fly_amr', ALLPH_WINDOW_PHOTONS),
            ('clumps_overlap.in with save_all_photons (K9)',
             clump_params('overlap', **over), None, 'fly_clump_dense',
             2 * 10 ** 8),
            ('bicone_clump.in with save_all_photons (K10)',
             clump_params('bicone', **over), None, 'fly_clump_csr',
             5 * ALLPH_WINDOW_PHOTONS)):
        par.save_all_photons, par.nphotons = True, budget
        p, _ = rate_window(label, par, dev, min_s=0.3, amr_data=data)
        card = smi()
        assert flight_kernel(p.chunk) == fly
        kernel_times(p, card, label.split(' ')[0] + ' with the table', res,
                     (fly,), record=(fly,), suffix=ALLPH)
        del p


def shear_cpu():
    """lart_tpu's CPU figures (tools/shear_cpu_runs.py)."""
    return json.loads(SHEAR_CPU.read_text())


def within(got, want, sig):
    """|got - want| <= max(5% of want, 3 sig); the relative difference."""
    assert abs(got - want) <= max(0.05 * abs(want), 3.0 * sig), \
        (got, want, sig)
    return got / want - 1.0


def shear_cli(tmp, device, total):
    """The shearing box and the maps through the CLI, FITS written and read
    back: shear.in as written (the main path; W_esc + W_oor against the
    births summed on the device, <N_scatt> and the Jout rms against
    lart_tpu's CPU run within 5% or 3 sigma), and phase 4's cuts of the
    slab t1tau6.in and of t4tau7.in with calcJ, calcP and calcPnew on (the
    Jx_1D, Pa_1D and Pa_1D_new sections with their radius and geom_JPa;
    on the slab the closure sum(Pa raw rhokap_phys) = the scattered weight;
    each map against lart_tpu's CPU runs by testing.map_chi2 < 3, J1's
    spectrum not on the periodic slab: testing.map_keys).  Each
    run's launches go into total['shear'][name]."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.io.iofile import open_read
    from lart_tpu_torch.io.writer import read_spectrum
    sub = total.setdefault('shear', {})
    cpu = shear_cpu()
    path = ('refill_point', 'fly_cartesian', 'scatter_lya')

    out = Path(tmp) / 'shear.fits'
    with birth_tally() as born:
        rc, res, wall, launches = run_cli(namelist_variant(SHEAR_IN, tmp),
                                          out, device)
    assert rc == 0 and res.meta.omega_shear > 0.0
    spec = read_spectrum(str(out))
    jout = np.asarray(spec['Jout'], np.float64)
    assert np.all(np.isfinite(jout)) and jout.shape == spec['Xfreq'].shape
    w_birth = float(torch.stack(born).sum()) / res.nphotons
    w = res.W_escape + res.W_oor
    assert abs(w - w_birth) < 1e-3, (w, w_birth)
    c = cpu['shear']
    inv = math.sqrt(1.0 / res.nphotons + 1.0 / c['photons'])
    dN = within(res.nscatt_gas, c['N'], c['N_spread'] * inv)
    rms = testing.spectrum_rms(res.xfreq, res.Jout)
    drms = within(rms, c['rms'], c['rms_spread'] * inv)
    add_launches(total, launches, path)
    sub['shear'] = launches
    log(4, f'CLI shear.in as written ({res.nphotons} photons, 32x32x64, '
           f'omega_shear {res.meta.omega_shear:.6f}, FITS): W_esc '
           f'{res.W_escape:.6f} + W_oor {res.W_oor:.6f} = {w:.6f} against '
           f'the births {w_birth:.6f}; <N_scatt> {res.nscatt_gas:.2f} vs '
           f'lart_tpu {c["N"]:.2f} ({dN:+.4f}), Jout rms {rms:.4f} vs '
           f'{c["rms"]:.4f} ({drms:+.4f}; lart_tpu {c["photons"]} photons on '
           f'the CPU); wall {wall:.1f} s; launches {launches}')

    for name, (rel, cut, photons) in MAP_CUTS.items():
        out = Path(tmp) / f'{name}_maps.fits'
        nml = namelist_variant(rel, tmp, batch_size=B_MAIN,
                               nphotons=f'{photons:g}', calcJ='.true.',
                               calcP='.true.', calcPnew='.true.', **cut)
        rc, res, wall, launches = run_cli(nml, out, device)
        assert rc == 0
        geom = res.meta.geometry_JPa
        with open_read(str(out)) as f:
            for sec, arr in (('Jx_1D', res.J1), ('Pa_1D', res.Pa),
                             ('Pa_1D_new', res.Pnew)):
                g = f[sec]
                got = np.asarray(g['data'], np.float64)
                assert got.shape == arr.shape and np.all(np.isfinite(got))
                assert np.allclose(got, arr, rtol=1e-6, atol=0.0), sec
                assert np.array_equal(np.asarray(g['radius']), res.r_JPa)
                assert int(g.attrs['geom_JPa']) == geom, sec
        c = cpu[name]
        runs = c['runs']
        n_c = c['photons_per_run']
        maps = testing.run_maps(res)
        chi = {k: testing.map_chi2([r[k] for r in runs], n_c, [maps[k]],
                                   res.nphotons)
               for k in testing.map_keys(res.meta)}
        assert max(chi.values()) < 3.0, chi
        msg = ''
        if name == 'slab':
            lhs, rhs = testing.pa_closure(res)
            assert abs(lhs / rhs - 1.0) < 1e-5, (lhs, rhs)
            msg = (f'closure sum(Pa raw rhokap_phys) {lhs:.6e} against the '
                   f'scattered weight {rhs:.6e} ({lhs / rhs - 1.0:+.2e}); ')
        add_launches(total, launches, path)
        sub[f'{name}_maps'] = launches
        log(4, f'CLI {rel} cut ({", ".join(f"{k} {v}" for k, v in cut.items())}'
               f', {res.nphotons} photons) with the three maps '
               f'(geometry_JPa {geom}, {res.meta.nbin_JPa} bins; FITS '
               f'sections Jx_1D {res.J1.shape}, Pa_1D, Pa_1D_new): {msg}'
               f'maps chi2/dof against lart_tpu\'s CPU runs ({len(runs)} x '
               f'{n_c} photons) {chi}; sum Pnew / sum Pa '
               f'{res.Pnew.sum() / res.Pa.sum():.4f} (lart_tpu '
               f'{np.sum([r["Pnew"] for r in runs]) / np.sum([r["Pa"] for r in runs]):.4f}); '
               f'<N_scatt> {res.nscatt_gas:.2f}; wall {wall:.1f} s; launches '
               f'{launches}')


def maps_cost(p, card, reps=20):
    """What the maps cost K4 and K5 on one cycle's inputs of the prepared
    run: each kernel with its maps' pointers and without them (K5's
    instance without kExtra), back to back on the device, in turns with,
    without, without, with, on a copy of the run's state (the run's own
    stays for kernel_times); {kernel: (ms with, ms without)}."""
    from lart_tpu_torch import testing
    from lart_tpu_torch.transport import refill, scatter
    ch, st = p.chunk, testing.clone_state(p.state)
    fmod = sys.modules[type(ch.flight).__module__]
    tl = ch.zero_tallies(st.device)
    nomap = dataclasses.replace(tl, J1=None, Pa=None, Pnew=None)
    refill.refill(st, tl, ch.refill_params, p.seed, p.cycle, p.budget)
    pre_fly = testing.clone_state(st)
    ch.flight(st, tl, ch.fly_substeps)
    pre_sc = testing.clone_state(st)
    c, sp, n = p.cycle, ch.scatter_params, ch.fly_substeps
    out = {}
    for name, pre, fns in (
            ('scatter_lya', pre_sc,
             {True: lambda s: scatter.scatter(s, tl, sp, 1, c),
              False: lambda s: scatter.scatter(s, nomap, sp, 1, c)}),
            ('fly_cartesian', pre_fly,
             {True: lambda s: fmod.fly(s, tl, ch.flight, n),
              False: lambda s: fmod.fly(s, nomap, ch.flight, n)})):
        got = {True: [], False: []}
        for k in (True, False, False, True):
            copies = [testing.clone_state(pre) for _ in range(reps)]
            got[k].append(device_ms([lambda s=s: fns[k](s) for s in copies]))
            del copies
        out[name] = (float(np.mean(got[True])), float(np.mean(got[False])))
        log(5, f'slab with the maps: {name} with its maps {out[name][0]:.6f}'
               f' ms, without them {out[name][1]:.6f} ms (back to back, in '
               f'turns): {out[name][0] / out[name][1]:.3f}x [{card}]')
    return out


def shear_phase5(dev, res):
    """Two windows: shear.in as written (the main path, budget 1e9) and the
    flagship slab t1tau6.in as written with the three maps (K5's deposits
    and K4's Pa), each with its profile and the kernel times of K2, K5 and
    K4 against their plain versions and bounds, the second also with K4's
    and K5's cost of the maps (maps_cost); K5's shear instance from the
    first, K5's deposits and K4's Pa from the second go into the kernels
    line."""
    over = dict(batch_size=B_MAIN, nphotons=10 ** 9, chunk_cycles=32)
    p, _ = rate_window('shear.in as written (32x32x64, omega_shear 2.2, '
                       'Hubble Vexp 10, tau 1e4)',
                       example_params(SHEAR_IN, **over), dev)
    card = smi()
    profile_chunks(p, card, 'shear')
    kernel_times(p, card, 'shear', res, ('refill_point', 'fly_cartesian',
                                         'scatter_lya'),
                 record=(('fly_cartesian', SHEAR_K),))
    del p
    p, _ = rate_window('t1tau6.in as written with calcJ, calcP and calcPnew '
                       '(1x1x129, tau 1e6, via K5)',
                       example_params('slab/t1tau6.in', **over, **JPA_ON),
                       dev)
    card = smi()
    profile_chunks(p, card, 'slab with the maps')
    maps_cost(p, card)
    kernel_times(p, card, 'slab with the maps', res,
                 ('refill_point', 'fly_cartesian', 'scatter_lya'),
                 record=(('fly_cartesian', DEPOSITS), ('scatter_lya', PA)))
    del p


# phase 6: several ranks (parallel/).  The config of (a) and (b):
# t4tau7.in cut to taumax 1e3 and 2e4 photons at B = 4096 a rank, with the
# table and one observer, so the drain of two ranks crosses the 512 rung
RANKS_OVER = dict(taumax=1e3, nphotons=20000, batch_size=4096,
                  save_all_photons=True, **OBSERVER)
RANKS_SEED = 16
ALL_REDUCE = ('all_reduce (tally psum)', 'lart_tpu_torch/parallel/reduce.py',
              'lart_tpu/parallel/mesh.py:69')


class CheckedCollectives:
    """While active, driver.run's collectives (chunk all-reduce, drain
    shrink, end reduce) also compute the single-rank result on the same
    inputs and require theirs bit for bit: at one rank the NCCL path is a
    copy.  Counts what it compared."""
    names = ('all_reduce_chunk', 'shrink', 'reduce_to_root')

    def __init__(self):
        self.n = {'chunks': 0, 'shrinks': 0, 'end': 0}

    def all_reduce_chunk(self, flat):
        from lart_tpu_torch.parallel import reduce as red
        want = flat.cpu().numpy().copy()
        got = red.all_reduce_chunk(flat)
        assert got.tobytes() == want.tobytes(), 'chunk buffer'
        self.n['chunks'] += 1
        return got

    def shrink(self, state, B_new):
        from lart_tpu_torch.parallel import reduce as red
        from lart_tpu_torch.transport.state import DEAD, LANE_FIELDS
        order = torch.argsort((state.phase == DEAD).to(torch.int8),
                              stable=True)
        want = state.select(order[:B_new])
        got = red.shrink(state, B_new)
        for f in LANE_FIELDS:
            assert torch.equal(getattr(got, f).view(torch.int32),
                               getattr(want, f).view(torch.int32)), f
        assert torch.equal(got.n_launched, want.n_launched)
        self.n['shrinks'] += 1
        return got

    def reduce_to_root(self, tensors):
        from lart_tpu_torch.parallel import reduce as red
        want = [t.cpu().clone() for t in tensors]
        got = red.reduce_to_root(tensors)
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == b.numpy().tobytes(), 'end reduce'
        self.n['end'] += len(tensors)
        return got

    def __enter__(self):
        from lart_tpu_torch import driver
        self.saved = {k: getattr(driver, k) for k in self.names}
        for k in self.names:
            setattr(driver, k, getattr(self, k))
        return self

    def __exit__(self, *exc):
        from lart_tpu_torch import driver
        for k, v in self.saved.items():
            setattr(driver, k, v)


def world1_identity(dev, par, seed=RANKS_SEED):
    """driver.run of par in this process inside a one-rank NCCL group, its
    collectives checked bit for bit against the single-rank path on the
    same inputs (CheckedCollectives); the RunResult and what was
    compared.  The group is left at the end."""
    from lart_tpu_torch import driver
    from lart_tpu_torch.parallel import distributed
    from lart_tpu_torch.parallel.launch import free_port
    distributed.initialize(f'127.0.0.1:{free_port()}', 1, 0,
                           backend='nccl', device=dev)
    try:
        assert distributed.backend() == 'nccl'
        with CheckedCollectives() as chk:
            res = driver.run(par, device=dev, seed=seed)
    finally:
        distributed.shutdown()
    assert chk.n['chunks'] > 0 and chk.n['end'] > 0, chk.n
    return res, chk.n


def overlapped_window(p, min_s):
    """window()'s (gas scatterings, seconds, chunks) with each chunk's read
    taken after the next chunk's launches: the all-reduce, then a copy
    into pinned memory that does not block the host, then the next
    chunk's launches, then a wait for the copy alone.  Not the driver's
    path (its decisions need the chunk's counts before the next chunk):
    it tells how much of the reduced path's cost is the host's wait at
    the read."""
    import torch.distributed as dist
    from lart_tpu_torch import driver
    at = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsc, n, prev = 0.0, 0, None
    while True:
        out = p.run_chunk()
        flat = driver.chunk_flat(*out)
        dist.all_reduce(flat)
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        if at is None:
            at = 3 * out[0].Jin.numel() + out[0].Jmu.numel()
        if prev is not None:
            prev[0].synchronize()
            nsc += float(prev[1][at])
            n += 1
        prev = (ev, host)
        if time.perf_counter() - t0 >= min_s:
            break
    prev[0].synchronize()
    nsc += float(prev[1][at])
    return nsc, time.perf_counter() - t0, n + 1


def pinned_read(out):
    """A chunk's flat buffer all-reduced and read through pinned memory:
    a copy that does not block the host, then a wait on its event."""
    import torch.distributed as dist
    from lart_tpu_torch import driver
    flat = driver.chunk_flat(*out)
    dist.all_reduce(flat)
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return host


def paired_chunks(p, rounds=200):
    """Wall ms a chunk of the plain read, the reduced read (driver.
    chunk_to_host with reduce False and True) and the reduced buffer read
    through pinned memory (pinned_read), taken in turns chunk by chunk, so
    that the host's drift between windows falls on all alike; each chunk
    from its launches to its read, which waits for it."""
    from lart_tpu_torch import driver
    reads = {'plain': lambda out: driver.chunk_to_host(*out, reduce=False),
             'reduced': lambda out: driver.chunk_to_host(*out),
             'pinned': pinned_read}
    t = dict.fromkeys(reads, 0.0)
    torch.cuda.synchronize()
    for _ in range(rounds):
        for mode, read in reads.items():
            t0 = time.perf_counter()
            read(p.run_chunk())
            t[mode] += time.perf_counter() - t0
    return {m: v / rounds * 1e3 for m, v in t.items()}


def all_reduce_times(p, card, reps=200):
    """The flagship chunk's flat buffer through one
    torch.distributed.all_reduce as the driver issues it (NCCL): ms of one
    call between CUDA events with a synchronize after each (the route is
    itself the one library call: ms and library_ms); through the plain
    route (the host read and a gloo all-reduce: wall ms a call between
    synchronizes); the host's cost of one call without a synchronize; the
    device ms a call back to back (at one rank NCCL's in-place all-reduce
    puts no work there that the events see); the bound (each byte read
    and written once at the memory rate).  max_abs_err holds NCCL's
    result against gloo's: at one rank both are copies, so it checks no
    sum (phase 6 (b) and tests/test_torch_parallel.py check the sum of
    two ranks).  Needs a one-rank NCCL group."""
    import torch.distributed as dist
    from lart_tpu_torch import driver
    from lart_tpu_torch.parallel import reduce as red
    buf = driver.chunk_flat(*p.run_chunk())
    got = buf.clone()
    dist.all_reduce(got)
    gloo = dist.new_group(backend='gloo')
    host = buf.cpu()
    dist.all_reduce(host, group=gloo)
    err = float((got.cpu() - host).abs().max())
    assert got.cpu().numpy().tobytes() == host.numpy().tobytes(), err
    for _ in range(10):
        red.all_reduce_chunk(buf.clone())
    ms = cuda_time(lambda: dist.all_reduce(buf), reps)
    b2b = device_ms([lambda: dist.all_reduce(buf) for _ in range(reps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        h = buf.cpu()
        dist.all_reduce(h, group=gloo)
    plain = (time.perf_counter() - t0) / reps * 1e3
    dist.destroy_process_group(gloo)
    nbytes = 2 * buf.numel() * buf.element_size()
    b_ms, by = bound(nbytes, 0)
    log(6, f'all-reduce of the flagship chunk\'s {buf.numel()} f64 '
           f'({buf.numel() * 8} bytes), NCCL at one rank: {ms:.6f} ms for '
           f'one call between events with its synchronize; the host '
           f'{host_us:.3f} us a call without one; back to back {b2b:.6f} ms '
           f'a call (no device work the events see); the host + gloo '
           f'{plain:.6f} ms; bound {b_ms:.6f} ms ({by}); max |err| against '
           f'gloo {err} (one rank: copies, no sum checked) [{card}]')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=ms)


def phase6(dev, res):
    """Several ranks: (a) NCCL at one rank.  run_ranks(par, 1) drives the
    entry point (launch counts read around it); driver.run of the same
    config inside a one-rank NCCL group, its every chunk all-reduce, drain
    shrink and end reduce bit for bit the single-rank path on the same
    inputs; windows of the flagship in turns, reduced and not; the
    all-reduce's times.  (b) Two gloo ranks sharing the card on the same
    config: the drain crosses the 512 rung with both ranks alive, every
    photon launched, every table id written by one rank, <nscatt_gas>
    within 5% or 3 sigma of (a)'s run and Jout chi2/dof < 3, the peel flux
    within 3 sigma.  Returns the launches of run_ranks(par, 1)."""
    from lart_tpu_torch import driver, testing
    from lart_tpu_torch.kernels import build as kb
    from lart_tpu_torch.parallel import distributed
    from lart_tpu_torch.parallel.launch import free_port, run_ranks
    t_phase = time.time()
    par = example_params('sphere/t4tau7.in', **RANKS_OVER)
    n = par.nphotons
    kb.reset_launch_counts()
    t0 = time.time()
    r1 = run_ranks(par, 1, 'cuda', seed=RANKS_SEED)
    t1 = time.time() - t0
    launches = dict(kb.LAUNCHES)
    need = ('refill_point', 'fly_cartesian', 'scatter_lya', 'peel',
            'all_reduce')
    assert all(launches[k] > 0 for k in need), launches
    assert r1.nprocs == 1
    card = smi()
    log(6, f'(a) run_ranks(t4tau7 at taumax 1e3, {n} photons, table, one '
           f'observer; 1 rank, NCCL) {t1:.1f} s: <nscatt_gas> '
           f'{r1.nscatt_gas:.4f}; launches '
           f'{ {k: v for k, v in launches.items() if v} } [{card}]')
    t0 = time.time()
    r0, compared = world1_identity(dev, par)
    log(6, f'(a) driver.run of the same config in a one-rank NCCL group '
           f'{time.time() - t0:.1f} s: every collective bit for bit the '
           f'single-rank path on the same inputs ({compared}); <nscatt_gas> '
           f'{r0.nscatt_gas:.4f} [{card}]')
    assert compared['shrinks'] > 0, compared
    # the flagship in short windows taken in turns, two rounds (the host's
    # speed drifts by tens of percent between windows): outside any group
    # ('alone', before the group is made and after it is left), and in a
    # one-rank NCCL group without the all-reduce ('plain'), through the
    # driver's reduced read ('reduced') and with each read after the next
    # chunk's launches ('overlapped'); the wall us a cycle and this
    # thread's CPU us a chunk, by their medians
    flag = testing.slab_params(tau0=1e6, nz=201, nphotons=10 ** 9,
                               batch=B_MAIN, chunk_cycles=32, refill_every=4,
                               scatter_rounds=4, save_Jmu=False)
    p = driver.prepare(flag, seed=12345, device=dev)
    for _ in range(3):
        driver.chunk_to_host(*p.run_chunk())
    modes = ('plain', 'reduced', 'overlapped')
    wall = {m: [] for m in ('alone',) + modes}
    cpu = {m: [] for m in wall}

    def timed(mode, min_s=WINDOW_S / 2):
        c0 = time.thread_time()
        if mode == 'overlapped':
            nsc, dt, nch = overlapped_window(p, min_s)
        else:
            nsc, dt, nch = window(p, min_s, reduce=mode == 'reduced')
        cpu[mode].append((time.thread_time() - c0) / nch * 1e6)
        wall[mode].append(dt / nch / flag.chunk_cycles * 1e6)
        log(6, f'flagship window, {mode}: {nsc:.6e} gas scatterings in '
               f'{dt:.6f} s over {nch} chunks = {nsc / dt:.6e} /s, '
               f'{wall[mode][-1]:.3f} us a cycle, this thread\'s CPU '
               f'{cpu[mode][-1]:.3f} us a chunk [{card}]')
    timed('alone')
    distributed.initialize(f'127.0.0.1:{free_port()}', 1, 0,
                           backend='nccl', device=dev)
    try:
        # the collective's first calls, untimed
        window(p, 0.0)
        overlapped_window(p, 0.0)
        for r in range(2):
            for mode in (modes if r % 2 == 0 else modes[::-1]):
                timed(mode)
        ms = paired_chunks(p)
        log(6, 'flagship, chunks in turns chunk by chunk: ' + '; '.join(
            f'{m} {v:.6f} ms a chunk (rate {ms["plain"] / v:.4f} x plain)'
            for m, v in ms.items()) + f' [{card}]')
        res[ALL_REDUCE[0]] = all_reduce_times(p, card)
    finally:
        distributed.shutdown()
    timed('alone')
    del p
    med = {m: (float(np.median(wall[m])), float(np.median(cpu[m])))
           for m in wall}
    log(6, 'flagship, medians of the windows in turns: ' + '; '.join(
        f'{m} {w:.3f} us a cycle (rate {med["plain"][0] / w:.4f} x plain), '
        f'CPU {c:.3f} us a chunk' for m, (w, c) in med.items())
        + f' [{card}]')
    # (b) two gloo ranks on the one card
    with tempfile.TemporaryDirectory() as tmp:
        metrics = Path(tmp) / 'metrics.jsonl'
        par2 = example_params('sphere/t4tau7.in', metrics_file=str(metrics),
                              **RANKS_OVER)
        t0 = time.time()
        r2 = run_ranks(par2, 2, 'cuda', seed=RANKS_SEED, shared=True)
        t2 = time.time() - t0
        rows = [json.loads(s) for s in metrics.read_text().splitlines()]
    assert r2.nprocs == 2
    rung = [r for r in rows[1:] if r['batch'] == 1024]
    assert rung and rung[0]['alive'] >= 2, rows[-5:]
    closures = testing.rank_table_closures(r2, rows[-1]['launched'])
    assert all(v <= lim for v, lim in closures.values()), closures
    sig = np.hypot(r2.allph['nscatt_gas'].std(),
                   r0.allph['nscatt_gas'].std()) / np.sqrt(n)
    for r in (r1, r2):
        d = abs(r.nscatt_gas - r0.nscatt_gas)
        assert d < 0.05 * r0.nscatt_gas or d < 3.0 * sig, (
            r.nscatt_gas, r0.nscatt_gas, sig)
    chi2, bins = testing.spectra_chi2(r2.Jout, r0.Jout, n * r2.W_escape,
                                      n * r0.W_escape)
    assert chi2 < 3.0, (chi2, bins)
    for r in (r0, r1, r2):
        assert abs(r.W_escape + r.W_oor - 1.0) < 1e-3, r.W_escape
    log(6, f'(b) two gloo ranks on one card {t2:.1f} s, {len(rows)} chunks: '
           f'the 512 rung at chunk {rung[0]["chunk"]} with {rung[0]["alive"]} '
           f'alive; launched {rows[-1]["launched"]} of {n}; closures '
           f'{ {k: v for k, (v, _) in closures.items()} }; <nscatt_gas> '
           f'{r2.nscatt_gas:.4f} against {r0.nscatt_gas:.4f} (3 sigma '
           f'{3 * sig:.4f}), Jout chi2/dof {chi2:.2f} over {bins} bins '
           f'[{card}]')
    tol = 3.0 * np.sqrt(2.0 * testing.PEEL_V_PHOTON / n)
    f2, f0 = testing.peel_closure(r2)[0], testing.peel_closure(r0)[0]
    assert abs(f2 - f0) <= tol, (f2, f0, tol)
    log(6, f'(b) 4 pi d^2 peel flux / W_esc: two ranks {f2:.4f}, one '
           f'{f0:.4f} (|d| <= {tol:.4f}) [{card}]')
    log(6, f'phase 6 {time.time() - t_phase:.1f} s')
    return launches


KERNELS = {
    'refill_point': ('lart_tpu_torch/csrc/refill.cu',
                     'lart_tpu/transport/engine.py:2557'),
    'fly_uniform_slab': ('lart_tpu_torch/csrc/fly_slab.cu',
                         'lart_tpu/transport/engine.py:671'),
    'fly_cartesian': ('lart_tpu_torch/csrc/fly_cartesian.cu',
                      'lart_tpu/transport/engine.py:1057'),
    'fly_uniform_sphere': ('lart_tpu_torch/csrc/fly_sphere.cu',
                           'lart_tpu/transport/engine.py:887'),
    'scatter_lya': ('lart_tpu_torch/csrc/scatter_lya.cu',
                    'lart_tpu/transport/engine.py:1838'),
    'peel': ('lart_tpu_torch/csrc/peel.cu',
             'lart_tpu/instruments/peel.py:62'),
}
INLINES_VOIGT = ('fly_uniform_slab', 'fly_cartesian', 'fly_uniform_sphere')
# the kernels' metal-line instances on this slice's path (K3's is held
# against its plain version in phase 2; no metal-line slab runs in phase 4)
LINE_KERNELS = {
    'refill_point': 'lart_tpu/transport/engine.py:2923',
    'fly_cartesian': 'lart_tpu/transport/engine.py:1057',
    'fly_uniform_sphere': 'lart_tpu/transport/engine.py:887',
    'scatter_lya': 'lart_tpu/transport/engine.py:1838',
    'peel': 'lart_tpu/instruments/peel.py:62',
}
LINE_INLINES = {
    'refill_point': 'branch_init_shift (lart_tpu_torch/csrc/line.cuh, '
                    'replaces lart_tpu/transport/engine.py:2923) in the '
                    'births of lart_tpu/transport/engine.py:2557',
    'scatter_lya': 'redistribute and line_profile (lart_tpu_torch/csrc/'
                   'line.cuh, replace lart_tpu/transport/engine.py:1931, '
                   ':621)',
}


# the kernels with this slice's branches, and the TPU functions they replace
SLICE_KERNELS = (
    ('fly_cartesian', 'lart_tpu/transport/engine.py:1057'),
    ('scatter_lya', 'lart_tpu/transport/engine.py:1838'),
    ('peel', 'lart_tpu/instruments/peel.py:62'))
SLICE_INLINES = {
    LT8: 'redistribute with the 3p -> 2s conversion (lart_tpu_torch/csrc/'
         'line.cuh, replaces lart_tpu/transport/engine.py:2053) and the '
         'H-alpha band\'s dust-only opacity (lart_tpu_torch/csrc/walk.cuh, '
         'replaces lart_tpu/transport/engine.py:1121)',
    H2: 'h2_kappa and h2_line_weight (lart_tpu_torch/csrc/h2.cuh, replace '
        'lart_tpu/physics/h2.py:109,123)',
}


AMR_KERNEL = ('lart_tpu_torch/csrc/fly_amr.cu',
              'lart_tpu/transport/engine.py:1507')
AMR_INLINES = ('amr_find_cell and amr_descend_from_face (lart_tpu_torch/csrc/'
               'amr.cuh, replace lart_tpu/transport/engine.py:548, :359)')
CLUMP_KERNELS = {
    'fly_clump_dense': ('lart_tpu_torch/csrc/fly_clump.cu',
                        'lart_tpu/transport/engine.py:3076'),
    'fly_clump_csr': ('lart_tpu_torch/csrc/fly_clump.cu',
                      'lart_tpu/transport/engine.py:3342')}
# the phase 4 run whose launches the kernels line gives for each clump
# kernel: the slice's main path clumps_overlap.in as written (K9, K2, K4),
# the same with one observer (K7), and bicone_clump.in (K10)
CLUMP_PATHS = {'fly_clump_dense': 'clumps_overlap',
               'refill_point': 'clumps_overlap',
               'scatter_lya': 'clumps_overlap',
               'peel': 'clumps_overlap_peel',
               'fly_clump_csr': 'bicone_clump'}
CLUMP_INLINES = ('clump_find, clump_owner and clump_cell_tau (lart_tpu_torch/'
                 'csrc/clump.cuh, replace lart_tpu/transport/engine.py:421, '
                 ':487 and lart_tpu/instruments/peel.py:86)')


SIGHTLINE_KERNEL = ('lart_tpu_torch/csrc/sightline.cu',
                    'lart_tpu/instruments/sightline.py:31')
INSIDE_INLINES = {
    'sightline': 'pix2vec_ring (lart_tpu_torch/csrc/healpix.cuh, replaces '
                 'lart_tpu/instruments/healpix.py:69), amr_find_cell, '
                 'amr_descend_from_face and clump_cell_exit (amr.cuh, '
                 'clump.cuh), line_profile (line.cuh)',
    'peel': 'vec2pix_ring (lart_tpu_torch/csrc/healpix.cuh, replaces '
            'lart_tpu/instruments/healpix.py:30) in the interior '
            'obs_geometry (lart_tpu/instruments/peel.py:394-415) with the '
            'capped sightline',
    'refill_radial': 'radius_loglog (lart_tpu_torch/csrc/refill.cu, replaces '
                    'lart_tpu/physics/sources.py:478) in gen_position\'s '
                    'exponential_cylinder (lart_tpu/transport/engine.py:'
                    '2629-2637)',
}


# K2's instances of the volume and table sources: each one's path and the
# TPU function it replaces
SOURCE_KERNELS = {
    'refill_volume': ('t4tau2', 'lart_tpu/transport/engine.py:2590'),
    'refill_radial': ('halo_0053', 'lart_tpu/transport/engine.py:2624'),
    'refill_alias': ('stars1', 'lart_tpu/transport/engine.py:2638')}
SOURCE_INLINES = {
    'refill_volume': 'gen_position\'s analytic volumes with _iso_sphere and '
                     '_zexp (lart_tpu/transport/engine.py:2563-2623), the '
                     'voigt0 and continuum+gaussian spectra (:2783, :2808)',
    'refill_radial': 'radius_loglog (replaces lart_tpu/physics/sources.py:'
                     '478) with the sersic/ssh and exponential tables '
                     '(sources.py:92, :77) and _iso_sphere',
    'refill_alias': 'the alias draw of a star, cell, leaf or profile bin '
                    '(replaces lart_tpu/physics/samplers.py:287 and '
                    'lart_tpu/physics/sources.py:486 sample_alias_linear) '
                    'with its composite weight (engine.py:2638-2685)'}


# the per-cell instances: the TPU function each replaces, and the gathers
# it gained
TEMP_REPLACES = {
    'refill_alias': 'lart_tpu/transport/engine.py:2771',
    'fly_cartesian': 'lart_tpu/transport/engine.py:1141',
    'scatter_lya': 'lart_tpu/transport/engine.py:2087',
    'peel': 'lart_tpu/instruments/peel.py:62',
    'sightline': 'lart_tpu/instruments/sightline.py:31'}
TEMP_INLINES = ('cell_voigt_a and cell_Dfreq (lart_tpu_torch/csrc/walk.cuh '
                'cell_a_D, replace lart_tpu/transport/engine.py:297, :309) '
                'with the comoving update ((x + u1) D1) / D2 - u2')


# this slice's entries of the kernels line: (name, the kernel's KERNELS
# key, the phase 4 run of its launches, its launch counter, the TPU
# function it replaces, what it inlines)
STELLAR_INLINES = ('peel_direct_stellar (replaces lart_tpu/instruments/'
                   'peel.py:709-836) and the core mask of the sightline '
                   '(peel.py:326-333)')
ATM_KERNELS = (
    ('refill_illum', 'refill_point', 'a090', 'refill_illum',
     'lart_tpu/physics/sources.py:354',
     'sample_stellar_illumination, sample_point_illumination and '
     'sample_limb_cost (replace lart_tpu/physics/sources.py:354, :421, '
     ':322) with plane_illumination (engine.py:2645) and the line_prof_file '
     'spectrum (engine.py:2826) in K2'),
    ('fly_cartesian' + ATM, 'fly_cartesian', 'a090', 'fly_cartesian',
     'lart_tpu/transport/engine.py:1259',
     'the atmosphere branches of make_fly (engine.py:1259-1272, :1302-1310,'
     ' :1322-1333, :1378-1382): Jabs2 at the bottom face and the masked '
     'core'),
    ('peel' + STELLAR_K, 'peel', 'a090', 'peel_stellar',
     'lart_tpu/instruments/peel.py:709', STELLAR_INLINES),
    ('peel' + STELLAR_Z, 'peel', 'a090_transit', 'peel_stellar',
     'lart_tpu/instruments/peel.py:709', STELLAR_INLINES))


# this slice's instances on its main paths: K5's shear wrap on shear.in,
# K5's deposits and K4's Pa on the slab with the maps (phase 5's windows,
# phase 4's launches): (name, KERNELS key, phase 4 run, replaces, inlines)
SHEAR_KERNELS = (
    ('fly_cartesian' + SHEAR_K, 'fly_cartesian', 'shear',
     'lart_tpu/transport/engine.py:1250',
     'the shear wrap of make_fly (engine.py:1250-1257, :1282-1313, '
     ':1406-1409) in K5\'s kExtra instance'),
    ('fly_cartesian' + DEPOSITS, 'fly_cartesian', 'slab_maps',
     'lart_tpu/transport/engine.py:1199',
     'jpa_bin and rhokap_phys (lart_tpu_torch/csrc/lart.cuh, replace '
     'lart_tpu/transport/engine.py:581, :606) in the J1 and Pnew deposits of '
     'make_fly (engine.py:1199-1219), summed by deposit_aggregated '
     '(lart.cuh) in f64'),
    ('scatter_lya' + PA, 'scatter_lya', 'slab_maps',
     'lart_tpu/transport/engine.py:2541',
     'jpa_bin and rhokap_phys (lart_tpu_torch/csrc/lart.cuh, replace '
     'lart_tpu/transport/engine.py:581, :606) in the Pa deposit of '
     'make_scatter (engine.py:2541-2547), summed by deposit_aggregated '
     '(lart.cuh) in f64'))


# the instances with the table on phase 4's paths: (KERNELS-like source and
# the TPU function it replaces, the phase 4 run of its launches)
ALLPH_KERNELS = {
    'refill_point': (KERNELS['refill_point'][0],
                     'lart_tpu/transport/engine.py:2885', 't4tau7'),
    'fly_cartesian': (KERNELS['fly_cartesian'][0],
                      'lart_tpu/transport/engine.py:1434', 't4tau7'),
    'scatter_lya': (KERNELS['scatter_lya'][0],
                    'lart_tpu/transport/engine.py:2455', 't4tau7'),
    'fly_amr': (AMR_KERNEL[0], 'lart_tpu/transport/engine.py:1761',
                'amr_sphere'),
    'fly_clump_dense': (CLUMP_KERNELS['fly_clump_dense'][0],
                        'lart_tpu/transport/engine.py:3302',
                        'clumps_overlap'),
    'fly_clump_csr': (CLUMP_KERNELS['fly_clump_csr'][0],
                      'lart_tpu/transport/engine.py:3684', 'bicone_clump')}
ALLPH_INLINES = ('allph_impact, allph_birth and allph_death (lart_tpu_torch/'
                 'csrc/allph.cuh, replace lart_tpu/transport/engine.py:172 '
                 'impact_parameter and :193 allph_record_death)')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--phases', default='0,1,2,3,4,5,6')
    phases = {int(v) for v in ap.parse_args(argv).phases.split(',')}
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    from lart_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase0()
    if 1 in phases:
        phase1()
    res = phase2(dev) if 2 in phases else {}
    log('-', f'phases 0-2 {time.time() - t_start:.1f} s')
    p3 = None
    if 3 in phases:
        p3 = multiprocessing.get_context('spawn').Process(
            target=phase3_process, args=(dev,))
        p3.start()
    try:
        launches = phase4() if 4 in phases else {}
        log('-', f'phase 4 (phase 3 beside it) ends at '
                 f'{time.time() - t_start:.1f} s')
    except BaseException:
        if p3 is not None:
            p3.terminate()
            p3.join()
        raise
    if p3 is not None:
        p3.join()
        if p3.exitcode != 0:
            raise RuntimeError(f'phase 3 failed (exit code {p3.exitcode})')
    log('-', f'phases 0-4 {time.time() - t_start:.1f} s')
    if 5 in phases:
        phase5(dev, res)
    if 6 in phases:
        launches['ranks'] = phase6(dev, res)
        log('-', f'phases 0-6 {time.time() - t_start:.1f} s')
    if phases >= {2, 4, 5, 6}:
        line = {'kernels': [dict(
            name=k, route='cuda', source=src, replaces=rep,
            launches=launches[k], max_abs_err=res[k]['max_abs_err'],
            ms=res[k]['ms'], plain_ms=res[k]['plain_ms'],
            bound_ms=res[k]['bound_ms'], bound_by=res[k]['bound_by'],
            library_ms=None,    # no one PyTorch call computes these
            **({'inlines': 'voigt_h (lart_tpu_torch/csrc/voigt.cuh, '
                           'replaces lart_tpu/physics/voigt.py:23)'}
               if k in INLINES_VOIGT + ('peel',) else {}))
            for k, (src, rep) in KERNELS.items()]}
        for entry in line['kernels']:
            if entry['name'] == 'peel':
                # K7's packed walks against the plain version (phase 2)
                entry['packed'] = res['peel' + PACKED]
        lines = launches.get('lines', {})
        line['kernels'] += [dict(
            name=k + LINES, route='cuda', source=KERNELS[k][0], replaces=rep,
            launches=lines[k], max_abs_err=res[k + LINES]['max_abs_err'],
            ms=res[k + LINES]['ms'], plain_ms=res[k + LINES]['plain_ms'],
            bound_ms=res[k + LINES]['bound_ms'],
            bound_by=res[k + LINES]['bound_by'], library_ms=None,
            inlines=LINE_INLINES.get(
                k, 'line_profile (lart_tpu_torch/csrc/line.cuh, replaces '
                   'lart_tpu/transport/engine.py:621)'))
            for k, rep in LINE_KERNELS.items()]
        # this slice's branches: line type 8 in the metal-line instances,
        # H2 in the instances built with it (launches of the examples'
        # runs in phase 4)
        for suffix, key, kernels in ((LT8, 'lyb', SLICE_KERNELS),
                                     (H2, 'h2', SLICE_KERNELS[:2])):
            counts = launches.get(key, {})
            line['kernels'] += [dict(
                name=k + suffix, route='cuda', source=KERNELS[k][0],
                replaces=rep, launches=counts[k],
                max_abs_err=res[k + suffix]['max_abs_err'],
                ms=res[k + suffix]['ms'], plain_ms=res[k + suffix]['plain_ms'],
                bound_ms=res[k + suffix]['bound_ms'],
                bound_by=res[k + suffix]['bound_by'], library_ms=None,
                inlines=SLICE_INLINES[suffix])
                for k, rep in kernels]
        # this slice's kernel K8 (its numbers from the 3.06M-leaf sphere)
        # and the AMR branches of K2, K4 and K7 (from jellyfish_pt), with
        # the launches of phase 4's AMR runs
        counts = launches['amr']
        line['kernels'].append(dict(
            name='fly_amr', route='cuda', source=AMR_KERNEL[0],
            replaces=AMR_KERNEL[1], launches=counts['fly_amr'],
            max_abs_err=res['fly_amr']['max_abs_err'],
            ms=res['fly_amr']['ms'], plain_ms=res['fly_amr']['plain_ms'],
            bound_ms=res['fly_amr']['bound_ms'],
            bound_by=res['fly_amr']['bound_by'], library_ms=None,
            inlines=AMR_INLINES))
        line['kernels'] += [dict(
            name=k + AMR, route='cuda', source=KERNELS[k][0],
            replaces=KERNELS[k][1], launches=counts[k],
            max_abs_err=res[k + AMR]['max_abs_err'], ms=res[k + AMR]['ms'],
            plain_ms=res[k + AMR]['plain_ms'],
            bound_ms=res[k + AMR]['bound_ms'],
            bound_by=res[k + AMR]['bound_by'], library_ms=None,
            inlines=AMR_INLINES)
            for k in ('refill_point', 'scatter_lya', 'peel')]
        # this slice's kernels K9 (its numbers from clumps_overlap) and K10
        # (from the 1.48M-clump population), and the clump branches of K2
        # and K4 (clumps_overlap) and K7 (clumps_overlap with its
        # observer); the launches are each path's own phase 4 run's
        counts = launches['clump']
        line['kernels'] += [dict(
            name=k, route='cuda', source=src, replaces=rep,
            launches=counts[CLUMP_PATHS[k]][k], path=CLUMP_PATHS[k],
            max_abs_err=res[k]['max_abs_err'],
            ms=res[k]['ms'], plain_ms=res[k]['plain_ms'],
            bound_ms=res[k]['bound_ms'], bound_by=res[k]['bound_by'],
            library_ms=None, inlines=CLUMP_INLINES)
            for k, (src, rep) in CLUMP_KERNELS.items()]
        line['kernels'] += [dict(
            name=k + CLUMP, route='cuda', source=KERNELS[k][0],
            replaces=KERNELS[k][1], launches=counts[CLUMP_PATHS[k]][k],
            path=CLUMP_PATHS[k],
            max_abs_err=res[k + CLUMP]['max_abs_err'],
            ms=res[k + CLUMP]['ms'], plain_ms=res[k + CLUMP]['plain_ms'],
            bound_ms=res[k + CLUMP]['bound_ms'],
            bound_by=res[k + CLUMP]['bound_by'], library_ms=None,
            inlines=CLUMP_INLINES)
            for k in ('refill_point', 'scatter_lya', 'peel')]
        # this slice's kernel K11 (its numbers from CIV_test's whole
        # nside-64 map) and the interior branch of K7 and the
        # exponential-cylinder births of K2 (CIV_test's window), with the
        # launches of phase 4's CIV_test run
        counts = launches['inside']
        line['kernels'].append(dict(
            name='sightline', route='cuda', source=SIGHTLINE_KERNEL[0],
            replaces=SIGHTLINE_KERNEL[1], launches=counts['sightline'],
            path='CIV_test', max_abs_err=res['sightline']['max_abs_err'],
            ms=res['sightline']['ms'], plain_ms=res['sightline']['plain_ms'],
            bound_ms=res['sightline']['bound_ms'],
            bound_by=res['sightline']['bound_by'], library_ms=None,
            inlines=INSIDE_INLINES['sightline']))
        line['kernels'] += [dict(
            name=k + suffix, route='cuda', source=KERNELS[base][0],
            replaces=KERNELS[base][1], launches=counts[k], path='CIV_test',
            max_abs_err=res[k + suffix]['max_abs_err'],
            ms=res[k + suffix]['ms'], plain_ms=res[k + suffix]['plain_ms'],
            bound_ms=res[k + suffix]['bound_ms'],
            bound_by=res[k + suffix]['bound_by'], library_ms=None,
            inlines=INSIDE_INLINES[k])
            for k, suffix, base in (('peel', INSIDE, 'peel'),
                                    ('refill_radial', EXPCYL, 'refill_point'))]
        # this slice's K2 instances: the volume one on t4tau2.in, the radial
        # one on halo_0053.in, the alias one on stars1.in (phase 5's windows
        # and each path's phase 4 launches)
        counts = launches['sources']
        line['kernels'] += [dict(
            name=k, route='cuda', source=KERNELS['refill_point'][0],
            replaces=rep, launches=counts[path][k], path=path,
            max_abs_err=res[k]['max_abs_err'], ms=res[k]['ms'],
            plain_ms=res[k]['plain_ms'], bound_ms=res[k]['bound_ms'],
            bound_by=res[k]['bound_by'], library_ms=None,
            inlines=SOURCE_INLINES[k])
            for k, (path, rep) in SOURCE_KERNELS.items()]
        # this slice's per-cell instances on the main path AlII_ex.in as
        # written (phase 5's window, phase 4's launches), and K8's kMulti
        # instance at each leaf's temperature (jellyfish_pt in Mg II)
        counts = launches['temperature']
        line['kernels'] += [dict(
            name=k + TEMP, route='cuda',
            source=(SIGHTLINE_KERNEL if k == 'sightline'
                    else KERNELS['refill_point' if k.startswith('refill')
                                 else k])[0],
            replaces=TEMP_REPLACES[k], launches=counts['AlII'][k],
            path='AlII', max_abs_err=res[k + TEMP]['max_abs_err'],
            ms=res[k + TEMP]['ms'], plain_ms=res[k + TEMP]['plain_ms'],
            bound_ms=res[k + TEMP]['bound_ms'],
            bound_by=res[k + TEMP]['bound_by'], library_ms=None,
            inlines=TEMP_INLINES)
            for k in TEMP_PATH]
        line['kernels'].append(dict(
            name='fly_amr' + LEAF_T, route='cuda', source=AMR_KERNEL[0],
            replaces=AMR_KERNEL[1],
            launches=counts['jellyfish_mg']['fly_amr'], path='jellyfish_mg',
            max_abs_err=res['fly_amr' + LEAF_T]['max_abs_err'],
            ms=res['fly_amr' + LEAF_T]['ms'],
            plain_ms=res['fly_amr' + LEAF_T]['plain_ms'],
            bound_ms=res['fly_amr' + LEAF_T]['bound_ms'],
            bound_by=res['fly_amr' + LEAF_T]['bound_by'], library_ms=None,
            inlines=TEMP_INLINES))
        # this slice's instances and branches on the main path
        # star_planet_a090.in as written, and PEEL_STELLAR on its +z
        # transit too (phase 5's windows, phase 4's launches)
        counts = launches['atmosphere']
        line['kernels'] += [dict(
            name=name, route='cuda', source=KERNELS[base][0], replaces=rep,
            launches=counts[path][launch], path=path,
            max_abs_err=res[name]['max_abs_err'], ms=res[name]['ms'],
            plain_ms=res[name]['plain_ms'], bound_ms=res[name]['bound_ms'],
            bound_by=res[name]['bound_by'], library_ms=None, inlines=inl)
            for name, base, path, launch, rep, inl in ATM_KERNELS]
        # this slice's K5 and K4 instances (shear.in, the slab with the
        # maps)
        counts = launches['shear']
        line['kernels'] += [dict(
            name=name, route='cuda', source=KERNELS[base][0], replaces=rep,
            launches=counts[path][base], path=path,
            max_abs_err=res[name]['max_abs_err'], ms=res[name]['ms'],
            plain_ms=res[name]['plain_ms'], bound_ms=res[name]['bound_ms'],
            bound_by=res[name]['bound_by'], library_ms=None, inlines=inl)
            for name, base, path, rep, inl in SHEAR_KERNELS]
        # this slice's instances with the all-photons table (t4tau7's
        # window and the K8, K9, K10 windows of phase 5, the launches of
        # each one's phase 4 run)
        counts = launches['allph']
        line['kernels'] += [dict(
            name=k + ALLPH, route='cuda', source=src, replaces=rep,
            launches=counts[path][k], path=path,
            max_abs_err=res[k + ALLPH]['max_abs_err'], ms=res[k + ALLPH]['ms'],
            plain_ms=res[k + ALLPH]['plain_ms'],
            bound_ms=res[k + ALLPH]['bound_ms'],
            bound_by=res[k + ALLPH]['bound_by'], library_ms=None,
            inlines=ALLPH_INLINES)
            for k, (src, rep, path) in ALLPH_KERNELS.items()]
        # row 20: the per-chunk all-reduce (NCCL, the flagship's buffer;
        # the launches of run_ranks at one rank in phase 6)
        name, src, rep = ALL_REDUCE
        line['kernels'].append(dict(
            name=name, route='cuda', source=src, replaces=rep,
            launches=launches['ranks']['all_reduce'], path='ranks',
            **res[name], via='torch.distributed.all_reduce over NCCL',
            note='one rank: ms is one call with its synchronize; '
                 'max_abs_err compares two copies and checks no sum (the '
                 'sum of two ranks: phase 6 (b), '
                 'tests/test_torch_parallel.py)'))
        print(json.dumps(line))
    assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)
    log('-', f'wall {time.time() - t_start:.1f} s')
    print(smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
