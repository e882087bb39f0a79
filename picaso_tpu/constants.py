"""Physical constants in CGS units.

The reference framework (picaso) pulls these from astropy
(``atmsetup.py:40-63``); we hard-code the CODATA values so the build has
no astropy dependency.  All RT math in this package is CGS:

* fluxes        : erg / s / cm^2 / cm^-1 (per wavenumber) or per cm
* pressure      : dyne / cm^2 (1 bar = 1e6 dyne/cm^2)
* temperature   : K
* wavenumber    : cm^-1
"""

import numpy as np

# --- fundamental constants (CGS) -------------------------------------------
K_B = 1.380649e-16           # Boltzmann, erg/K      (astropy c.k_B)
G_GRAV = 6.6743e-08          # gravitational, cm^3/g/s^2
AMU = 1.6605390666e-24       # atomic mass unit, g
R_GAS = 8.31446261815324     # molar gas constant, J/mol/K (SI value, used by
                             # the continuum amagat integral like optics.py:161)
H_PLANCK = 6.62607004e-27    # erg s   (value used in fluxes.py:1632)
C_LIGHT = 2.99792458e+10     # cm/s
K_B_REF = 1.38064852e-16     # Boltzmann value baked into fluxes.py:1634/1678;
                             # kept separately for bit-parity of Planck terms
SB_SIGMA = 5.67e-5           # Stefan-Boltzmann as used in justdoit.py:570

PI = np.pi

# --- unit conversions --------------------------------------------------------
PCONV = 1e6                  # bar -> dyne/cm^2 (atmsetup.py:50)
AVOGADRO = 6.02214086e+23    # used by rayleigh cross sections (rayleigh.py:110)

# Planck law helpers (CGS, matching fluxes.py blackbody routines)
PLANCK_C1 = 2.0 * H_PLANCK * C_LIGHT ** 2
PLANCK_C2 = H_PLANCK * C_LIGHT / K_B_REF
