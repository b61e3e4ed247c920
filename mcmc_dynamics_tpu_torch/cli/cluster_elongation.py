"""Cluster elongation/eccentricity CLI (the port of
``mcmc_dynamics_tpu/cli/cluster_elongation.py``).

Reads a photometry catalog (CSV with ra/dec or x/y columns), measures the
eccentricity and position angle per radial annulus from the position covariance
(with bootstrap errors), prints the result table as CSV and, where matplotlib
imports, writes an ellipse overlay plot (logged as skipped otherwise).  It runs
on the host: nothing here needs a GPU.

Usage: python -m mcmc_dynamics_tpu_torch.cli.cluster_elongation catalog.csv
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def _ellipse_plot(dx, dy, results, filename):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(dx.value, dy.value, s=2, alpha=0.3, color="0.6")
    for row in range(len(results)):
        r = results.value("r_max")[row]
        e = results.value("e")[row]
        theta = results.value("theta")[row]
        b_over_a = np.sqrt(1.0 - e ** 2)
        ax.add_patch(Ellipse((0, 0), 2 * r, 2 * r * b_over_a,
                             angle=np.degrees(theta) + 90.0, fill=False,
                             color="tab:red", lw=1.5))
    ax.set_xlabel("x [arcmin]")
    ax.set_ylabel("y [arcmin]")
    ax.set_aspect("equal")
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    logger.info("wrote %s", filename)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Measure cluster elongation per radial annulus.")
    parser.add_argument("catalog", help="CSV catalog with ra/dec (deg) or x/y "
                        "(arcmin) columns.")
    parser.add_argument("--center", nargs=2, type=float, default=None,
                        metavar=("RA", "DEC"),
                        help="Cluster centre (deg); default: catalog median.")
    parser.add_argument("--radii", nargs="+", type=float, default=None,
                        help="Annulus edges in arcmin.")
    parser.add_argument("--bootstrap", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("-o", "--output", default="elongation.png")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from .. import units as u
    from ..utils import Table, calc_xy_offset, get_eccentricity_and_pa

    table = Table.read(args.catalog, fmt="csv")
    if "x" in table and "y" in table:
        dx = u.Quantity(table.value("x"), "arcmin")
        dy = u.Quantity(table.value("y"), "arcmin")
    else:
        ra = table.value("ra")
        dec = table.value("dec")
        if args.center:
            ra_c, dec_c = args.center
        else:
            ra_c, dec_c = float(np.median(ra)), float(np.median(dec))
        dx, dy = calc_xy_offset(u.Quantity(ra, "deg"), u.Quantity(dec, "deg"),
                                ra_c * u.deg, dec_c * u.deg)

    results = get_eccentricity_and_pa(dx, dy, radii=args.radii,
                                      bootstrap=args.bootstrap, seed=args.seed)
    results.write(sys.stdout, fmt="csv")

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.info("matplotlib is not installed: %s skipped", args.output)
        return 0
    _ellipse_plot(dx, dy, results, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
