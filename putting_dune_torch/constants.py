"""Physical and RL constants shared across the port.

A copy of putting_dune_tpu/constants.py: the port imports nothing of the
JAX package, so it keeps its own copy of these numbers.
"""

import numpy as np

# Atomic numbers.
CARBON = 6
SILICON = 14

CARBON_BOND_DISTANCE_ANGSTROMS = 1.42

# Silicon-doped graphene (SiGr) prior transition-rate parameters.
# The prior says transitions peak when the beam sits 0.85 bond-lengths from
# the silicon, along the direction of the target neighbor, with isotropic
# Gaussian falloff (variance 0.1 in bond-length units).
SIGR_PRIOR_RATE_MEAN = np.array((0.85, 0.0), dtype=np.float32)
SIGR_PRIOR_RATE_COV = np.array(((0.1, 0.0), (0.0, 0.1)), dtype=np.float32)
SIGR_PRIOR_MAX_RATE = float(np.log(2.0) / 3.0)

# Per-simulated-second RL discount. 0.9967**3 ~= 0.99 for a 3-second step.
GAMMA_PER_SECOND = 0.9967

# Kinetic-Monte-Carlo waiting times are clipped here to avoid inf when the
# total transition rate is tiny.
MAX_WAITING_TIME_SECONDS = 3600.0
