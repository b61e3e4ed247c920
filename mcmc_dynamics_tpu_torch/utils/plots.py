"""Diagnostic plotting: chain traces, corner (triangle) plots, radial-profile figures,
KDE contours.

A copy of ``mcmc_dynamics_tpu/utils/plots.py`` (host-side matplotlib only; a
native triangle plot, without the ``corner`` package).  Importing this module
imports matplotlib, so the port imports it only inside the functions that
draw: nothing on a sampling path needs matplotlib.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import gridspec  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402
from matplotlib.ticker import MaxNLocator  # noqa: E402

from .. import units as u

__all__ = ["plot_chain", "corner_plot", "ProfilePlot", "get_kde_contours"]


def plot_chain(chain, labels=None, filename: Optional[str] = "chains.png",
               true_values=None, lnprob=None, figure=None, plot_median=False):
    """Trace plot: one panel per fitted parameter, one line per walker
    (reference runner.py:675-765). ``chain``: (walkers, steps, params)."""
    chain = np.asarray(chain)
    n_params = chain.shape[-1]
    if labels is None:
        labels = [f"p{i}" for i in range(n_params)]

    if figure is not None:
        assert len(figure.axes) == n_params, \
            "No. of axes does not match no. of parameters."
        axes = figure.axes
    else:
        figure = plt.figure(figsize=(8, 1 + 2 * n_params))
        gs = gridspec.GridSpec(n_params, 1)
        ax_ref = None
        axes = []
        for i in range(n_params):
            ax = figure.add_subplot(gs[i], sharex=ax_ref)
            ax_ref = ax_ref or ax
            axes.append(ax)

    for i in range(n_params):
        samples = chain[..., i]
        if lnprob is None:
            axes[i].plot(samples.T, color="#AAAAAA", alpha=0.1)
        else:
            lp = np.asarray(lnprob)
            steps = np.arange(chain.shape[1])
            vmin, vmax = np.percentile(lp, [5, 95])
            norm = plt.Normalize(vmin, vmax)
            for w in range(chain.shape[0]):
                pts = np.column_stack([steps, samples[w]])
                segs = np.stack([pts[:-1], pts[1:]], axis=1)
                lc = LineCollection(segs, cmap="viridis", norm=norm, alpha=0.3)
                lc.set_array(lp[w, 1:])
                axes[i].add_collection(lc)
        axes[i].set_ylim(samples.min(), samples.max())
        axes[i].set_xlim(0, chain.shape[1])
        axes[i].yaxis.set_major_locator(MaxNLocator(5))
        if plot_median:
            for pct, lw in ((16, 1.0), (50, 1.5), (84, 1.0)):
                axes[i].plot(np.percentile(samples, pct, axis=0),
                             color="tab:red", lw=lw)
        if true_values is not None:
            axes[i].axhline(true_values[i], color="#888888", lw=2)
        axes[i].set_ylabel(labels[i])

    figure.tight_layout(h_pad=0.0)
    if filename is not None:
        figure.savefig(filename)
    return figure


def corner_plot(samples, labels=None, quantiles=(0.16, 0.5, 0.84), bins=40,
                filename: Optional[str] = "corner.png", truths=None,
                show_titles: bool = True, **kwargs):
    """Triangle plot of 1D/2D posterior distributions (replaces the external
    ``corner`` package used at reference runner.py:801)."""
    samples = np.asarray(samples)
    ndim = samples.shape[1]
    if labels is None:
        labels = [f"p{i}" for i in range(ndim)]

    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    if ndim == 1:
        axes = np.array([[axes]])

    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                x = samples[:, i]
                ax.hist(x, bins=bins, histtype="step", color="k", density=True)
                for q in quantiles:
                    ax.axvline(np.quantile(x, q), color="k", ls="--", lw=0.8)
                if truths is not None:
                    ax.axvline(truths[i], color="tab:blue")
                if show_titles:
                    q16, q50, q84 = np.quantile(x, [0.16, 0.5, 0.84])
                    ax.set_title(f"{labels[i]} = {q50:.3g} "
                                 f"(+{q84 - q50:.2g}/-{q50 - q16:.2g})", fontsize=8)
                ax.set_yticks([])
            else:
                x, y = samples[:, j], samples[:, i]
                rng = [[x.min(), x.max()], [y.min(), y.max()]]
                h, xe, ye = np.histogram2d(x, y, bins=bins, range=rng)
                h = h.T
                # contour levels enclosing ~(39, 86, 98.9)% (1/2/3 sigma in 2D)
                flat = np.sort(h.ravel())[::-1]
                csum = np.cumsum(flat) / max(flat.sum(), 1)
                levels = sorted({flat[np.searchsorted(csum, p)]
                                 for p in (0.393, 0.865, 0.989) if p < 1.0})
                ax.hist2d(x, y, bins=bins, range=rng, cmap="Greys")
                if len(levels) >= 2:
                    ax.contour(0.5 * (xe[1:] + xe[:-1]), 0.5 * (ye[1:] + ye[:-1]),
                               h, levels=levels, colors="k", linewidths=0.8)
                if truths is not None:
                    ax.axvline(truths[j], color="tab:blue")
                    ax.axhline(truths[i], color="tab:blue")
            if i == ndim - 1:
                ax.set_xlabel(labels[j], fontsize=10)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i], fontsize=10)
            elif j != i:
                ax.set_yticklabels([])

    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename)
    return fig


class ProfilePlot:
    """Three-panel kinematics figure: v_rot(r) (log-x), polar theta_0(r), sigma(r)
    (reference utils/plots/profile_plot.py:17-130)."""

    def __init__(self, figure=None):
        if figure is None:
            figure = plt.figure(figsize=(8, 8))
        self.figure = figure
        gs = gridspec.GridSpec(2, 2, height_ratios=[1, 1])
        self.ax_rot = figure.add_subplot(gs[0, 0])
        self.ax_theta = figure.add_subplot(gs[0, 1], projection="polar")
        self.ax_disp = figure.add_subplot(gs[1, :], sharex=self.ax_rot)

        self.ax_rot.set_xscale("log")
        self.ax_rot.set_ylabel(r"$v_{\rm rot}$ [km/s]")
        self.ax_disp.set_xscale("log")
        self.ax_disp.set_xlabel(r"$r$ [arcsec]")
        self.ax_disp.set_ylabel(r"$\sigma$ [km/s]")

    @staticmethod
    def _vals(x):
        return x.value if isinstance(x, u.Quantity) else np.asarray(x)

    def add_rotation_profile(self, x, y, xerr=None, yerr=None, fill_between=False,
                             **kwargs):
        x, y = self._vals(x), self._vals(y)
        if fill_between and yerr is not None:
            lo = y - self._vals(yerr[0])
            hi = y + self._vals(yerr[1])
            self.ax_rot.fill_between(x, lo, hi, alpha=kwargs.pop("alpha", 0.3),
                                     color=kwargs.get("c", "g"))
            kwargs.pop("marker", None)
            self.ax_rot.plot(x, y, **_plot_kwargs(kwargs))
        else:
            self.ax_rot.errorbar(x, y, xerr=_err(xerr), yerr=_err(yerr),
                                 **_marker_kwargs(kwargs))

    def add_dispersion_profile(self, x, y, xerr=None, yerr=None, fill_between=False,
                               **kwargs):
        x, y = self._vals(x), self._vals(y)
        if fill_between and yerr is not None:
            lo = y - self._vals(yerr[0])
            hi = y + self._vals(yerr[1])
            self.ax_disp.fill_between(x, lo, hi, alpha=kwargs.pop("alpha", 0.3),
                                      color=kwargs.get("c", "g"))
            kwargs.pop("marker", None)
            self.ax_disp.plot(x, y, **_plot_kwargs(kwargs))
        else:
            self.ax_disp.errorbar(x, y, xerr=_err(xerr), yerr=_err(yerr),
                                  **_marker_kwargs(kwargs))

    def add_theta_profile(self, x, theta, yerr=None, **kwargs):
        x = self._vals(x)
        theta = self._vals(theta)
        self.ax_theta.errorbar(theta, np.log10(np.maximum(x, 1e-3)),
                               xerr=_err(yerr), **_marker_kwargs(kwargs))

    def add_scale_radius(self, r, **kwargs):
        r = float(self._vals(r))
        for ax in (self.ax_rot, self.ax_disp):
            ax.axvline(r, ls=":", color=kwargs.get("c", "0.5"))

    def savefig(self, filename):
        self.figure.tight_layout()
        self.figure.savefig(filename)


def _err(e):
    if e is None:
        return None
    if isinstance(e, u.Quantity):
        return np.abs(e.value)
    return np.abs(np.asarray([x.value if isinstance(x, u.Quantity) else x for x in e])) \
        if isinstance(e, (list, tuple)) else np.abs(np.asarray(e))


def _marker_kwargs(kwargs):
    out = dict(kwargs)
    out.setdefault("marker", "o")
    out.setdefault("ls", "None")
    if out.get("marker") == "None":
        out["marker"] = None
    if out.get("ls") == "None":
        out["ls"] = "-" if out.get("marker") is None else ""
    return out


def _plot_kwargs(kwargs):
    out = dict(kwargs)
    out.pop("fill_between", None)
    return out


def get_mapping_significance(kernel, significances, n_mc: int = 20000,
                             seed: int = 0):
    """Iso-density values above which the given probability masses of a KDE lie
    (API parity with reference contour_plot.py:26-63, computed directly by Monte
    Carlo instead of the reference's iso-level bisection walk)."""
    rng = np.random.default_rng(seed)
    sample = kernel.resample(n_mc, seed=rng)
    densities = np.sort(kernel(sample))[::-1]
    significances = np.atleast_1d(significances)
    return np.array([densities[min(int(p * n_mc), n_mc - 1)]
                     for p in significances])


def get_kde_contours(x, y, levels=(0.393, 0.865, 0.989), grid_size=100,
                     n_mc: int = 20000, seed: int = 0):
    """2D Gaussian-KDE contour levels enclosing the requested probability masses,
    found by Monte-Carlo sampling of the KDE (reference contour_plot.py:6-64).

    Returns (X, Y, Z, level_values) for ``plt.contour``.
    """
    from scipy import stats

    x = np.asarray(x)
    y = np.asarray(y)
    kde = stats.gaussian_kde(np.vstack([x, y]))
    level_values = get_mapping_significance(kde, levels, n_mc=n_mc, seed=seed)

    xi = np.linspace(x.min(), x.max(), grid_size)
    yi = np.linspace(y.min(), y.max(), grid_size)
    X, Y = np.meshgrid(xi, yi)
    Z = kde(np.vstack([X.ravel(), Y.ravel()])).reshape(X.shape)
    return X, Y, Z, sorted(set(level_values.tolist()))
