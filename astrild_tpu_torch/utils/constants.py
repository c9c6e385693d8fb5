"""Physical constants the port needs (copied from
astrild_tpu/utils/constants.py, whose package import pulls in JAX).

Unit system: lengths in Mpc/h, velocities in km/s, H0 = 100 h km/s/Mpc.
"""

# Speed of light
C_LIGHT_KMS = 299792.458  # km/s

# Gravitational constant: G = 4.300917270e-9 Mpc (km/s)^2 / Msun; with
# h-units the h's cancel
G_NEWTON = 4.300917270e-9  # Mpc (km/s)^2 / Msun

# Hubble constant in h-units
H0_HUNITS = 100.0  # km/s / (Mpc/h)

# Critical density today: rho_crit = 3 H0^2 / (8 pi G)
RHO_CRIT0 = 2.775366272e11  # (Msun/h) / (Mpc/h)^3
H0_OVER_C_HMPC = 1.0 / 2997.92458  # H0/c in h/Mpc (c = 1 units)

DEG2RAD = 0.017453292519943295
ARCMIN2RAD = DEG2RAD / 60.0
RAD2ARCMIN = 1.0 / ARCMIN2RAD
