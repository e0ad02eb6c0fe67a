"""Atomic data and physical constants for the hydrogen Lyman series.

All derived quantities (line strengths, Lorentzian widths, instrumental
profile) are computed from first principles at import time rather than
stored as opaque tables.

Conformance: the base atomic data (vacuum transition wavelengths,
oscillator strengths, damping constants) match the tables used by the
reference pipeline (reference: gpy_dla_detection/voigt.py:21-127,
voigt.c:31-251); the derived leading constants agree with the
reference's precomputed values to ~2e-7 relative (the reference baked
in slightly different CODATA values for e and m_e).

The port's own copy of ``gpy_dla_detection_tpu/constants.py`` (numpy
only), kept equal to it name for name and number for number so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Fundamental constants (CGS)
# ---------------------------------------------------------------------------
SPEED_OF_LIGHT_CGS: float = 2.99792458e10  # cm s^-1
SPEED_OF_LIGHT_SI: float = 299792458.0  # m s^-1
ELECTRON_CHARGE_ESU: float = 4.80320425e-10  # esu
ELECTRON_MASS_G: float = 9.10938356e-28  # g

# Thermal broadening velocity dispersion for a fixed gas temperature of
# 10^4 K (13 km/s); fixed in Garnett (2017).  [cm s^-1]
# (reference: gpy_dla_detection/voigt.py:129-132)
THERMAL_SIGMA_CGS: float = 9.08537121627923800e05

# ---------------------------------------------------------------------------
# Hydrogen Lyman series atomic data (31 members, Lya ... Ly-31)
# Vacuum wavelengths in cm; oscillator strengths dimensionless;
# damping constants Gamma in s^-1.
# (reference: gpy_dla_detection/voigt.py:21-127)
# ---------------------------------------------------------------------------
LYMAN_WAVELENGTHS_CM: np.ndarray = np.array([
    1.2156701e-05, 1.0257223e-05, 9.725368e-06, 9.497431e-06, 9.378035e-06,
    9.307483e-06, 9.262257e-06, 9.231504e-06, 9.209631e-06, 9.193514e-06,
    9.181294e-06, 9.171806e-06, 9.164290e-06, 9.158240e-06, 9.153290e-06,
    9.149190e-06, 9.145760e-06, 9.142860e-06, 9.140390e-06, 9.138260e-06,
    9.136410e-06, 9.134800e-06, 9.133390e-06, 9.132150e-06, 9.131040e-06,
    9.130060e-06, 9.129180e-06, 9.128390e-06, 9.127680e-06, 9.127030e-06,
    9.126450e-06,
])

LYMAN_OSCILLATOR_STRENGTHS: np.ndarray = np.array([
    0.416400, 0.079120, 0.029000, 0.013940, 0.007799, 0.004814, 0.003183,
    0.002216, 0.001605, 0.001200, 0.000921, 0.0007226, 0.000577, 0.000469,
    0.000386, 0.000321, 0.000270, 0.000230, 0.000197, 0.000170, 0.000148,
    0.000129, 0.000114, 0.000101, 0.000089, 0.000080, 0.000071, 0.000064,
    0.000058, 0.000053, 0.000048,
])

LYMAN_GAMMAS: np.ndarray = np.array([
    6.265e08, 1.897e08, 8.127e07, 4.204e07, 2.450e07, 1.236e07, 8.255e06,
    5.785e06, 4.210e06, 3.160e06, 2.432e06, 1.911e06, 1.529e06, 1.243e06,
    1.024e06, 8.533e05, 7.186e05, 6.109e05, 5.237e05, 4.523e05, 3.933e05,
    3.443e05, 3.030e05, 2.679e05, 2.382e05, 2.127e05, 1.907e05, 1.716e05,
    1.550e05, 1.405e05, 1.277e05,
])

NUM_LYMAN_LINES: int = LYMAN_WAVELENGTHS_CM.shape[0]

# Convenience: wavelengths in Angstrom
LYMAN_WAVELENGTHS_A: np.ndarray = LYMAN_WAVELENGTHS_CM * 1e8
LYA_WAVELENGTH_A: float = float(LYMAN_WAVELENGTHS_A[0])  # 1215.6701
LYB_WAVELENGTH_A: float = 1025.7223
LYMAN_LIMIT_A: float = 911.7633

# ---------------------------------------------------------------------------
# Derived line quantities
# ---------------------------------------------------------------------------
# Integrated classical cross-section per unit column density:
#   leading[i] = pi e^2 f_i lambda_i / (m_e c)   [cm^2]
# (reference: gpy_dla_detection/voigt.py:134-170)
LYMAN_LEADING_CONSTANTS: np.ndarray = (
    np.pi
    * ELECTRON_CHARGE_ESU**2
    * LYMAN_OSCILLATOR_STRENGTHS
    * LYMAN_WAVELENGTHS_CM
    / (ELECTRON_MASS_G * SPEED_OF_LIGHT_CGS)
)

# Lorentzian HWHM in velocity units:
#   gamma[i] = Gamma_i lambda_i / (4 pi)   [cm s^-1]
# (reference: gpy_dla_detection/voigt.py:172-208)
LYMAN_LORENTZIAN_WIDTHS: np.ndarray = (
    LYMAN_GAMMAS * LYMAN_WAVELENGTHS_CM / (4.0 * np.pi)
)

# ---------------------------------------------------------------------------
# CIV doublet atomic data (reference: gpy_dla_detection/voigt_civ.py:23-88)
# ---------------------------------------------------------------------------
CIV_WAVELENGTHS_CM: np.ndarray = np.array([1.5482040e-05, 1.5507810e-05])
CIV_OSCILLATOR_STRENGTHS: np.ndarray = np.array([0.189900, 0.094750])
CIV_GAMMAS: np.ndarray = np.array([2.643e08, 2.628e08])

CIV_LEADING_CONSTANTS: np.ndarray = (
    np.pi
    * ELECTRON_CHARGE_ESU**2
    * CIV_OSCILLATOR_STRENGTHS
    * CIV_WAVELENGTHS_CM
    / (ELECTRON_MASS_G * SPEED_OF_LIGHT_CGS)
)
CIV_LORENTZIAN_WIDTHS: np.ndarray = (
    CIV_GAMMAS * CIV_WAVELENGTHS_CM / (4.0 * np.pi)
)

# ---------------------------------------------------------------------------
# SDSS instrumental broadening profile
# ---------------------------------------------------------------------------
# A normalized 7-tap Gaussian kernel (sigma^2 ~= 0.85 pixels^2, i.e. the
# SDSS R ~ 2000 resolution element at 1e-4 dex pixel spacing).  Values match
# the reference (gpy_dla_detection/voigt.py:214-224, voigt.c:24-29) exactly.
INSTRUMENT_PROFILE_HALF_WIDTH: int = 3
INSTRUMENT_PROFILE: np.ndarray = np.array([
    2.17460992138080811e-03,
    4.11623059580451742e-02,
    2.40309364651846963e-01,
    4.32707438937454059e-01,
    2.40309364651846963e-01,
    4.11623059580451742e-02,
    2.17460992138080811e-03,
])
