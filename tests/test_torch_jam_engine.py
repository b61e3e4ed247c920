"""The port's batched JAM moment engine and polar-grid tier against the JAX
package's, float64 on the CPU.

Positions run from 0.3" to beyond 20 sigma of the outer tracer Gaussian; the
MGE is flattened, has three components and a zero-intensity one; cases with
and without a black hole, with per-component beta/kappa/mscale, and with an
invalid deprojection.  Gate: 1e-10 of each field's scale (its largest absolute
value).  A batch of walkers equals each walker alone, and the grid tier's
arrays and moments equal the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu.models.jam import grid as jax_grid
from mcmc_dynamics_tpu.models.jam.moments import jam_los_moments as jax_moments
from mcmc_dynamics_tpu_torch.models.jam import grid as port_grid
from mcmc_dynamics_tpu_torch.models.jam.moments import jam_los_moments as port_moments

torch.set_num_threads(1)

REL = 1e-10
# a flattened tracer MGE with a zero-intensity slot (as stack_mge_grid pads)
# and a mass MGE of its own
MGE = dict(lum_i=[8000.0, 1500.0, 400.0, 0.0], lum_s=[6.0, 20.0, 40.0, 1.0],
           lum_q=[0.75, 0.8, 0.7, 1.0],
           mass_i=[16000.0, 3000.0, 900.0], mass_s=[6.0, 22.0, 45.0],
           mass_q=[0.78, 0.75, 0.72])


def positions(n=100, seed=0):
    """~100 sky positions from 0.3" to 1000" (25 sigma of the 40" Gaussian)."""
    rng = np.random.default_rng(seed)
    r = np.geomspace(0.3, 1000.0, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    return r * np.cos(phi), r * np.sin(phi)


def t64(v):
    return torch.as_tensor(np.asarray(v, np.float64))


def assert_fields(got, want):
    for name in ("vz", "v2zz"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        scale = np.max(np.abs(w))
        assert scale > 0 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * scale, err_msg=name)
    assert bool(np.asarray(got.valid).all()) == bool(np.asarray(want.valid))


CASES = {
    "no_bh": dict(d=5.0, beta=0.1, kappa=0.6, mscale=2.0,
                  incl=math.radians(70.0), mbh=0.0, rbh=1.0),
    "bh": dict(d=5.0, beta=0.1, kappa=0.6, mscale=2.0,
               incl=math.radians(70.0), mbh=2e5, rbh=0.5),
    "per_component": dict(d=7.0, beta=[0.3, 0.1, -0.2, 0.0],
                          kappa=[0.2, 0.8, 1.1, 0.5], mscale=[2.5, 2.0, 1.5],
                          incl=math.radians(55.0), mbh=5e4, rbh=1.0),
    "edge_on": dict(d=5.0, beta=0.0, kappa=1.0, mscale=1.0,
                    incl=math.radians(89.5), mbh=0.0, rbh=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moments_match_jax(case):
    x, y = positions()
    kw = CASES[case]
    want = jax_moments(x, y, **MGE, **kw)
    port_kw = {k: (t64(v) if isinstance(v, list) else v) for k, v in kw.items()}
    got = port_moments(t64(x), t64(y), **{k: t64(v) for k, v in MGE.items()},
                       **port_kw)
    assert got.vz.shape == (1, x.size)
    assert_fields(type(got)(got.vz[0], got.v2zz[0], got.valid), want)


def test_invalid_deprojection_flag():
    """cos i above an observed axis ratio: valid is False in both packages."""
    x, y = positions(20)
    kw = dict(d=5.0, beta=0.0, kappa=0.0, mscale=1.0, incl=math.radians(20.0))
    want = jax_moments(x, y, **MGE, **kw)
    got = port_moments(t64(x), t64(y), **{k: t64(v) for k, v in MGE.items()}, **kw)
    assert not bool(np.asarray(want.valid)) and not bool(got.valid[0])
    # beta >= 1 is invalid too
    got = port_moments(t64(x), t64(y), **{k: t64(v) for k, v in MGE.items()},
                       **dict(kw, incl=math.radians(70.0), beta=1.0))
    assert not bool(got.valid[0])


def test_walker_batch_equals_each_walker_alone():
    """(W, 1) per-walker scalars, (W, L) per-component values and (W, N)
    positions: every row equals that walker alone, and the JAX package's."""
    x, y = positions(60, seed=1)
    rng = np.random.default_rng(2)
    W = 5
    d = rng.uniform(4.0, 6.0, W)
    incl = np.radians(rng.uniform(60.0, 85.0, W))
    mbh = rng.uniform(1e3, 1e5, W)
    kappa = rng.uniform(0.1, 0.9, (W, 4))
    mscale = rng.uniform(1.5, 2.5, (W, 1))
    theta = rng.uniform(-0.3, 0.3, (W, 1))      # a per-walker frame rotation
    xw = x * np.cos(theta) + y * np.sin(theta)
    yw = -x * np.sin(theta) + y * np.cos(theta)
    batch = port_moments(t64(xw), t64(yw), **{k: t64(v) for k, v in MGE.items()},
                         d=t64(d), beta=0.1, kappa=t64(kappa), mscale=t64(mscale),
                         incl=t64(incl), mbh=t64(mbh), rbh=1.0)
    assert batch.vz.shape == (W, x.size) and batch.valid.shape == (W,)
    for w in range(W):
        alone = port_moments(t64(xw[w]), t64(yw[w]),
                             **{k: t64(v) for k, v in MGE.items()},
                             d=float(d[w]), beta=0.1, kappa=t64(kappa[w]),
                             mscale=float(mscale[w, 0]), incl=float(incl[w]),
                             mbh=float(mbh[w]), rbh=1.0)
        for name in ("vz", "v2zz"):
            np.testing.assert_allclose(getattr(batch, name)[w].numpy(),
                                       getattr(alone, name)[0].numpy(),
                                       rtol=1e-13, atol=1e-13)
        want = jax_moments(xw[w], yw[w], **MGE, d=d[w], beta=0.1, kappa=kappa[w],
                           mscale=mscale[w, 0], incl=incl[w], mbh=mbh[w], rbh=1.0)
        assert_fields(type(alone)(batch.vz[w], batch.v2zz[w], batch.valid[w]), want)


def test_grid_spec_arrays_match_jax():
    x, y = positions(300, seed=3)
    want = jax_grid.JamGridSpec.build(x, y, n_r=24, n_phi=8, dtype=jnp.float64)
    got = port_grid.JamGridSpec.build(x, y, n_r=24, n_phi=8, dtype=torch.float64)
    assert (got.n_r, got.n_phi) == (want.n_r, want.n_phi)
    for name in got._fields:
        if name in ("n_r", "n_phi"):
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("mbh", [0.0, 3e4])
def test_grid_moments_match_jax(mbh):
    """jam_grid_moments through each package's engine, with a frame rotation,
    for a batch of three walkers against the JAX package one at a time."""
    x, y = positions(200, seed=4)
    kw = dict(d=5.0, beta=0.1, mscale=2.0, incl=math.radians(70.0), rbh=1.0)
    kappas, thetas = [0.3, 0.6, 0.9], [0.0, 0.4, -1.1]
    spec_j = jax_grid.JamGridSpec.build(x, y, n_r=32, n_phi=8, dtype=jnp.float64)
    spec_t = port_grid.JamGridSpec.build(x, y, n_r=32, n_phi=8, dtype=torch.float64)
    floor = 0.09
    mbh_t = t64(np.full(3, mbh)) if mbh else 0.0

    def at_t(gx, gy):
        r = port_moments(gx, gy, **{k: t64(v) for k, v in MGE.items()}, **kw,
                         kappa=t64(kappas)[:, None], mbh=mbh_t, n_u=16, n_zeta=24)
        return r.vz, r.v2zz, r.valid

    vz, v2, valid = port_grid.jam_grid_moments(spec_t, at_t, t64(thetas), floor=floor)
    assert vz.shape == (3, x.size) and valid.shape == (3,)
    for w in range(3):
        def at_j(gx, gy, w=w):
            r = jax_moments(gx, gy, **MGE, **kw, kappa=kappas[w], mbh=mbh,
                            n_u=16, n_zeta=24)
            return r.vz, r.v2zz, r.valid

        vz_j, v2_j, ok_j = jax_grid.jam_grid_moments(spec_j, at_j, thetas[w],
                                                     floor=floor)
        np.testing.assert_allclose(vz[w].numpy(), np.asarray(vz_j), rtol=0,
                                   atol=REL * np.max(np.abs(vz_j)))
        np.testing.assert_allclose(v2[w].numpy(), np.asarray(v2_j), rtol=0,
                                   atol=REL * np.max(np.abs(v2_j)))
        assert bool(valid[w]) == bool(ok_j)
