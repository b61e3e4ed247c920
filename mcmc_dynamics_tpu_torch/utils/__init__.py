"""Host utilities of the port: copies of ``mcmc_dynamics_tpu/utils`` modules
(the table, the catalog reader and the sky geometry).  ``plots`` is imported
only where a figure is drawn, so nothing else needs matplotlib."""

from .coordinates import (calc_cartesian_pm, calc_xy_offset, get_amplitude_and_angle,
                          get_perspective_rotation, xy_offset_rad)
from .data import DataReader, RadialProfile, radial_bin_numbers
from .table import Table

__all__ = ["Table", "DataReader", "RadialProfile", "radial_bin_numbers",
           "xy_offset_rad", "calc_xy_offset", "calc_cartesian_pm",
           "get_perspective_rotation", "get_amplitude_and_angle"]
