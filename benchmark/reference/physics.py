"""Atomic data and constants of the Lyman series (numpy only).

The benchmark's own copy: the hydrogen Lyman series (31 members) as the
DLA pipeline tabulates it (vacuum wavelengths, oscillator strengths,
damping constants), the fixed thermal broadening of 10^4 K gas, and the
7-tap SDSS instrumental profile.  The reference and the input generators
read these; nothing here comes from the program.
"""

from __future__ import annotations

import numpy as np

SPEED_OF_LIGHT_CGS = 2.99792458e10  # cm/s
SPEED_OF_LIGHT_SI = 299792458.0  # m/s
ELECTRON_CHARGE_ESU = 4.80320425e-10
ELECTRON_MASS_G = 9.10938356e-28
THERMAL_SIGMA_CGS = 9.08537121627923800e05  # cm/s

LYMAN_WAVELENGTHS_CM = np.array([
    1.2156701e-05, 1.0257223e-05, 9.725368e-06, 9.497431e-06, 9.378035e-06,
    9.307483e-06, 9.262257e-06, 9.231504e-06, 9.209631e-06, 9.193514e-06,
    9.181294e-06, 9.171806e-06, 9.164290e-06, 9.158240e-06, 9.153290e-06,
    9.149190e-06, 9.145760e-06, 9.142860e-06, 9.140390e-06, 9.138260e-06,
    9.136410e-06, 9.134800e-06, 9.133390e-06, 9.132150e-06, 9.131040e-06,
    9.130060e-06, 9.129180e-06, 9.128390e-06, 9.127680e-06, 9.127030e-06,
    9.126450e-06,
])
LYMAN_OSC = np.array([
    0.416400, 0.079120, 0.029000, 0.013940, 0.007799, 0.004814, 0.003183,
    0.002216, 0.001605, 0.001200, 0.000921, 0.0007226, 0.000577, 0.000469,
    0.000386, 0.000321, 0.000270, 0.000230, 0.000197, 0.000170, 0.000148,
    0.000129, 0.000114, 0.000101, 0.000089, 0.000080, 0.000071, 0.000064,
    0.000058, 0.000053, 0.000048,
])
LYMAN_GAMMAS = np.array([
    6.265e08, 1.897e08, 8.127e07, 4.204e07, 2.450e07, 1.236e07, 8.255e06,
    5.785e06, 4.210e06, 3.160e06, 2.432e06, 1.911e06, 1.529e06, 1.243e06,
    1.024e06, 8.533e05, 7.186e05, 6.109e05, 5.237e05, 4.523e05, 3.933e05,
    3.443e05, 3.030e05, 2.679e05, 2.382e05, 2.127e05, 1.907e05, 1.716e05,
    1.550e05, 1.405e05, 1.277e05,
])
LYMAN_WAVELENGTHS_A = LYMAN_WAVELENGTHS_CM * 1e8
LYMAN_LIMIT_A = 911.7633
# pi e^2 f lambda / (m_e c): the integrated cross-section [cm^2 cm/s]
LYMAN_LEADING = (np.pi * ELECTRON_CHARGE_ESU**2 * LYMAN_OSC * LYMAN_WAVELENGTHS_CM
                 / (ELECTRON_MASS_G * SPEED_OF_LIGHT_CGS))
# Lorentzian half width in velocity, Gamma lambda / (4 pi) [cm/s]
LYMAN_GAMMA_V = LYMAN_GAMMAS * LYMAN_WAVELENGTHS_CM / (4.0 * np.pi)

INSTRUMENT_PROFILE = np.array([
    2.17460992138080811e-03, 4.11623059580451742e-02, 2.40309364651846963e-01,
    4.32707438937454059e-01, 2.40309364651846963e-01, 4.11623059580451742e-02,
    2.17460992138080811e-03,
])

LOG_2PI = 1.8378770664093453
