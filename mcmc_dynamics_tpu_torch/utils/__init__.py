"""Host utilities of the port: copies of ``mcmc_dynamics_tpu/utils`` modules
(the table, the catalog reader, the sky geometry, the MGE reader, the
morphology and the integrated kinematics).  ``plots`` is imported only where a
figure is drawn, so nothing else needs matplotlib."""

from .coordinates import (calc_cartesian_pm, calc_xy_offset, get_amplitude_and_angle,
                          get_perspective_rotation, xy_offset_rad)
from .data import DataReader, RadialProfile, radial_bin_numbers
from .mge import (MgeReader, get_mge, get_nearest_neighbour_idx,
                  get_nearest_neigbhbour_idx, get_nearest_neigbhbour_idx2,
                  stack_mge_grid)
from .morphology import find_barq_limits, get_eccentricity_and_pa
from .science import VSigma
from .table import Table

__all__ = ["Table", "DataReader", "RadialProfile", "radial_bin_numbers",
           "xy_offset_rad", "calc_xy_offset", "calc_cartesian_pm",
           "get_perspective_rotation", "get_amplitude_and_angle",
           "MgeReader", "get_mge", "get_nearest_neighbour_idx",
           "get_nearest_neigbhbour_idx", "get_nearest_neigbhbour_idx2",
           "stack_mge_grid", "find_barq_limits", "get_eccentricity_and_pa", "VSigma"]
