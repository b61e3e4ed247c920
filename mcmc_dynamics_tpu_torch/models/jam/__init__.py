"""The axisymmetric Jeans (JAM) models, ported from
``mcmc_dynamics_tpu/models/jam``: the batched moment engine, the polar-grid
tier and the model classes."""

from .moments import JamMoments, jam_los_moments
from .axisymmetric import Axisymmetric
from .radial_profiles import AnalyticalProfiles
from .chemo import ChemoProfiles

__all__ = ["jam_los_moments", "JamMoments", "Axisymmetric", "AnalyticalProfiles",
           "ChemoProfiles"]
