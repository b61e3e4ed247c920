"""The port's emcee backends (``emcee_backends.py``): the HDF5 part of the
surface of ``tests/test_emcee_compat.py``, the file layout against the JAX
package's backend (a file the port writes reads back through the JAX
package's ``HDFBackend`` with the same datasets and attributes, the random
state apart), and a resume in another process, bit for bit."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcmc_dynamics_tpu_torch import emcee_compat
from test_torch_emcee_compat import EnsembleSampler, _scipy_lnprob, _torch_lnprob

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


class TestHDFBackend:
    def _run(self, backend, seed, chunks, p0):
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=seed, backend=backend)
        first = p0
        for n in chunks:
            s.run_mcmc(first, n)
            first = None
        return s

    def test_bitwise_cross_process_resume(self, tmp_path):
        """An interrupted run resumed from the file by a *fresh* sampler
        equals the uninterrupted run bitwise (the PRNG key rides the file)."""
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        p0 = np.random.default_rng(1).normal(size=(16, 2))
        ref = self._run(backends.HDFBackend(str(tmp_path / "a.h5")), 3,
                        [20, 20], p0)
        full = ref.get_chain()

        self._run(backends.HDFBackend(str(tmp_path / "b.h5")), 3, [20], p0)
        # fresh backend object + fresh sampler with a DIFFERENT seed: the
        # resume must come entirely from the file
        be = backends.HDFBackend(str(tmp_path / "b.h5"))
        assert be.iteration == 20
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=999, backend=be)
        s.run_mcmc(None, 20)
        np.testing.assert_array_equal(full, s.get_chain())
        np.testing.assert_array_equal(np.asarray(ref.backend.accepted),
                                      np.asarray(be.accepted))

    def test_no_file_bloat_on_step_by_step_appends(self, tmp_path):
        """Per-step sample() appends must overwrite the saved state in place:
        HDF5 never reclaims deleted-dataset storage, so a del/create per
        append used to leak (W*K + W + key) * 8 bytes per step."""
        import os
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        fn = str(tmp_path / "bloat.h5")
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=4,
                            backend=backends.HDFBackend(fn))
        p0 = np.random.default_rng(7).normal(size=(16, 2))
        it = s.sample(p0, iterations=10)
        for _ in range(5):
            next(it)
        base = os.path.getsize(fn)
        for _ in range(5):
            next(it)
        grown = os.path.getsize(fn) - base
        # 5 more stored steps of (16, 2) chain + (16,) lnP = 1920 data bytes;
        # allow generous HDF5 chunking overhead, but far below the ~5 x state
        # re-creations (~2 kB apiece) the leak produced
        per_step_data = 16 * (2 + 1) * 8
        assert grown <= 5 * per_step_data + 4096, grown

    def test_numpy_path_resume(self, tmp_path):
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        p0 = np.zeros((8, 2))

        def run(fn, chunks):
            be = backends.HDFBackend(str(tmp_path / fn))
            s = EnsembleSampler(8, 2, _scipy_lnprob, seed=5, backend=be)
            assert s.backend_kind == "numpy"
            first = p0
            for n in chunks:
                s.run_mcmc(first, n)
                first = None
            return s.get_chain()

        full = run("a.h5", [10, 10])
        run("b.h5", [10])
        be = backends.HDFBackend(str(tmp_path / "b.h5"))
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=77, backend=be)
        s.run_mcmc(None, 10)
        np.testing.assert_array_equal(full, s.get_chain())

    def test_reader_surface_and_reset(self, tmp_path):
        from mcmc_dynamics_tpu_torch.emcee_compat import State, backends

        be = backends.HDFBackend(str(tmp_path / "c.h5"))
        p0 = np.random.default_rng(2).normal(size=(16, 2))
        self._run(be, 4, [25], p0)

        reader = backends.HDFBackend(str(tmp_path / "c.h5"), read_only=True)
        assert reader.get_chain(discard=5, thin=2).shape == (10, 16, 2)
        assert reader.get_chain(flat=True).shape == (25 * 16, 2)
        assert reader.get_log_prob().shape == (25, 16)
        assert isinstance(reader.get_last_sample(), State)
        with pytest.raises(RuntimeError, match="read-only"):
            reader.reset(16, 2)

        # emcee v3 file layout: group "mcmc" with chain (S, W, K) et al.
        import h5py
        with h5py.File(str(tmp_path / "c.h5"), "r") as f:
            g = f["mcmc"]
            assert g["chain"].shape == (25, 16, 2)
            assert g["log_prob"].shape == (25, 16)
            assert g["accepted"].shape == (16,)
            assert int(g.attrs["iteration"]) == 25
            assert not g.attrs["has_blobs"]

        # sampler.reset() clears the file chain like emcee's backend.reset
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=4, backend=be)
        s.reset()
        assert be.iteration == 0

    def test_shape_mismatch_rejected(self, tmp_path):
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        be = backends.HDFBackend(str(tmp_path / "d.h5"))
        self._run(be, 6, [5], np.random.default_rng(3).normal(size=(16, 2)))
        with pytest.raises(ValueError, match="backend holds"):
            EnsembleSampler(8, 3, _torch_lnprob, backend=be)


def _layout(fn):
    """{dataset: array} and {attribute: value} of a backend file's group."""
    import h5py

    with h5py.File(fn, "r") as f:
        g = f["mcmc"]
        return ({k: np.asarray(g[k]) for k in g}, dict(g.attrs))


def test_port_file_reads_through_the_jax_backend(tmp_path):
    """A chain the port writes opens with the JAX package's HDFBackend, and
    its layout is the JAX package's: the same datasets and attributes; only
    the random state differs (the torch generator's bytes, key_impl
    "torch")."""
    from mcmc_dynamics_tpu import emcee_backends as jax_backends
    from mcmc_dynamics_tpu import emcee_compat as jax_emcee

    p0 = np.random.default_rng(5).normal(size=(16, 2))
    port = EnsembleSampler(16, 2, _torch_lnprob, seed=3,
                           backend=emcee_compat.backends.HDFBackend(
                               str(tmp_path / "port.h5")))
    port.run_mcmc(p0, 12, thin_by=2)
    reader = jax_backends.HDFBackend(str(tmp_path / "port.h5"), read_only=True)
    np.testing.assert_array_equal(reader.get_chain(), port.get_chain())
    np.testing.assert_array_equal(reader.get_log_prob(discard=2, thin=3),
                                  port.get_log_prob(discard=2, thin=3))
    assert reader.iteration == 12 and reader.proposals == 24

    jax_emcee.EnsembleSampler(16, 2, lambda t: -0.5 * (t[0] ** 2 + t[1] ** 2),
                              seed=3, backend=jax_backends.HDFBackend(
                                  str(tmp_path / "jax.h5"))).run_mcmc(p0, 12,
                                                                      thin_by=2)
    (data, attrs), (jdata, jattrs) = (_layout(tmp_path / "port.h5"),
                                      _layout(tmp_path / "jax.h5"))
    assert sorted(data) == sorted(jdata) and sorted(attrs) == sorted(jattrs)
    for name in jdata:
        if name != "key_data":
            assert data[name].shape == jdata[name].shape, name
            assert data[name].dtype == jdata[name].dtype, name
    assert data["key_data"].dtype == np.uint8 and attrs["key_impl"] == "torch"
    for name, value in jattrs.items():
        if name != "key_impl":
            assert attrs[name] == value, name


def test_jax_numpy_path_file_resumes_in_the_port(tmp_path):
    """A NumPy-path chain the JAX package wrote (its bit-generator state in
    the file) continues in the port as it would have in the JAX package."""
    from mcmc_dynamics_tpu import emcee_backends as jax_backends
    from mcmc_dynamics_tpu import emcee_compat as jax_emcee

    p0 = np.zeros((8, 2))
    full = jax_emcee.EnsembleSampler(8, 2, _scipy_lnprob, seed=5)
    full.run_mcmc(p0, 10)
    full.run_mcmc(None, 10)
    jax_emcee.EnsembleSampler(8, 2, _scipy_lnprob, seed=5, backend=jax_backends
                              .HDFBackend(str(tmp_path / "j.h5"))).run_mcmc(p0, 10)
    s = EnsembleSampler(8, 2, _scipy_lnprob, seed=77,
                        backend=emcee_compat.backends.HDFBackend(str(tmp_path / "j.h5")))
    s.run_mcmc(None, 10)
    np.testing.assert_array_equal(s.get_chain(), full.get_chain())


_WRITER = """
import sys
import numpy as np
import torch
from mcmc_dynamics_tpu_torch.emcee_compat import EnsembleSampler, backends

def lnprob(theta):
    d0 = theta[0] - 1.0
    d1 = theta[1] + 2.0
    return -0.5 * (d0 * d0 + d1 * d1 + d0 * d1)

p0 = np.random.default_rng(1).normal(size=(16, 2))
EnsembleSampler(16, 2, lnprob, seed=3, device="cpu",
                backend=backends.HDFBackend(sys.argv[1])).run_mcmc(p0, 20)
assert "jax" not in sys.modules
"""


def test_bitwise_resume_in_another_process(tmp_path):
    """Another process writes 20 steps; a sampler here (another seed) resumes
    from the file, and the 40 steps equal an uninterrupted run's bits."""
    proc = subprocess.run([sys.executable, "-c", _WRITER, str(tmp_path / "w.h5")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    p0 = np.random.default_rng(1).normal(size=(16, 2))
    whole = EnsembleSampler(16, 2, _torch_lnprob, seed=3)
    whole.run_mcmc(p0, 40)
    backend = emcee_compat.backends.HDFBackend(str(tmp_path / "w.h5"))
    resumed = EnsembleSampler(16, 2, _torch_lnprob, seed=999, backend=backend)
    resumed.run_mcmc(None, 20)
    np.testing.assert_array_equal(whole.get_chain(), backend.get_chain())
    np.testing.assert_array_equal(whole.get_log_prob(), backend.get_log_prob())


def test_in_memory_backend_resume_is_bitwise():
    """300 + 300 steps through an in-memory Backend handed to a fresh
    sampler give the bits of 600 (chip_smoke's path L3 on the card)."""
    p0 = np.random.default_rng(2).normal(size=(16, 2))
    whole = EnsembleSampler(16, 2, _torch_lnprob, seed=8)
    whole.run_mcmc(p0, 60)
    backend = emcee_compat.backends.Backend()
    EnsembleSampler(16, 2, _torch_lnprob, seed=8, backend=backend).run_mcmc(p0, 30)
    EnsembleSampler(16, 2, _torch_lnprob, seed=1, backend=backend).run_mcmc(None, 30)
    np.testing.assert_array_equal(whole.get_chain(), backend.get_chain())
    np.testing.assert_array_equal(whole.backend.accepted, backend.accepted)

