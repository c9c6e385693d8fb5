"""Physical constants the port needs (copied from
astrild_tpu/utils/constants.py, whose package import pulls in JAX).

Unit system: lengths in Mpc/h, velocities in km/s, H0 = 100 h km/s/Mpc.
"""

# Speed of light
C_LIGHT_KMS = 299792.458  # km/s

# Gravitational constant, (Mpc/h) (km/s)^2 / (Msun/h)
G_MPC_KMS2_MSUN = 4.300917270e-9 / 1.0e3  # 4.3009e-9 Mpc Msun^-1 (km/s)^2 -> Mpc
# G = 4.300917270e-9 Mpc (km/s)^2 / Msun; with h-units the h's cancel
G_NEWTON = 4.300917270e-9  # Mpc (km/s)^2 / Msun

# Hubble constant in h-units
H0_HUNITS = 100.0  # km/s / (Mpc/h)

# Critical density today: rho_crit = 3 H0^2 / (8 pi G)
RHO_CRIT0 = 2.775366272e11  # (Msun/h) / (Mpc/h)^3
H0_OVER_C_HMPC = 1.0 / 2997.92458  # H0/c in h/Mpc (c = 1 units)

DEG2RAD = 0.017453292519943295
ARCMIN2RAD = DEG2RAD / 60.0
RAD2ARCMIN = 1.0 / ARCMIN2RAD

# CMB temperature [K]
T_CMB = 2.7255

# Megaparsec in km
MPC_KM = 3.085677581491367e19

# Thomson cross-section [Mpc^2] (6.6524587158e-29 m^2)
SIGMA_T_MPC2 = 6.6524587158e-29 / MPC_KM ** 2 * 1.0e-6  # m^2 -> km^2 -> Mpc^2

# Proton mass [Msun]
M_PROTON_MSUN = 1.67262192369e-27 / 1.98892e30

# Electron mass [Msun]
M_ELECTRON_MSUN = 9.1093837015e-31 / 1.98892e30
