"""Physical constants and unit conversions.

Values mirror the reference implementation's conventions
(reference: src/define.f90:43-77, src/line_mod.f90:555-560) so that
normalizations agree to the last digit.  All values are plain Python
floats (f64); device code casts as needed.

The port's own copy of lart_tpu/constants.py, which has no jax in it:
lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step.
"""

import math

PI = math.pi
TWOPI = 2.0 * math.pi
FOURPI = 4.0 * math.pi
HALFPI = 0.5 * math.pi

# Distances
PC2CM = 3.0856776e18
KPC2CM = PC2CM * 1e3
AU2CM = 1.4960e13
ANG2M = 1.0e-10
ANG2KM = 1.0e-13
UM2M = 1.0e-6
UM2KM = 1.0e-9

# speed of light [km/s]
SPEEDC = 2.99792458e5
# speed of light [cm/s]
SPEEDC_CM = 2.99792458e10
# Planck constant [m^2 kg / s]
H_PLANCK = 6.62607004e-34
# Hydrogen mass [kg]
MASSH = 1.6737236e-27
# atomic mass unit [g]
AMU = 1.67262192e-24
# Lya H-line (2S1/2-2P1/2) wavelength [um]
WAVELENGTH_LYAH = 0.1215673123130

# sigma_0 = pi e^2 / (m_e c) [cm^2 Hz]  (line_mod.f90:556)
SIGMA_0 = 0.026540083434
# thermal speed of a 1-amu particle at 1 K: sqrt(2 k_B (1 K)/amu) [km/s]
VTHERM1_AMU = 0.12895319011972164

SQRTPI = math.sqrt(math.pi)
ONE_OVER_SQRTPI = 1.0 / math.sqrt(math.pi)

# optical depth above which exp(-tau) underflows f64 (raytrace_car.f90:106)
TAU_HUGE = 745.2
