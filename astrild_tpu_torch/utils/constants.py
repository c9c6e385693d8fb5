"""Physical constants the port needs (copied from
astrild_tpu/utils/constants.py, whose package import pulls in JAX).

Unit system: lengths in Mpc/h, velocities in km/s, H0 = 100 h km/s/Mpc.
"""

# Speed of light
C_LIGHT_KMS = 299792.458  # km/s
