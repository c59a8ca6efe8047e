"""Checkpointed NUTS (``stats/checkpoint.py``) on the CPU.

- The checkpoint's round trip, with and without samples, keeps every array
  (the generator state as uint8) and the metadata.
- A write that dies midway (a half-written temporary file, or an
  exception inside ``np.savez``) leaves the previous checkpoint loadable.
- ``fit_with_checkpointing`` on ``rbc_estimation`` (the state space's
  batched log posterior, float64): a run stopped by a failure after its
  first segment and called again equals the unbroken run bit for bit, its
  diagnostics come from the transitions (the reference returns zeros,
  ones and ``False``), and calling a finished run again returns its draws.
- On the reference test's Gaussian ``TinyTarget`` the port's sampler and
  the reference's agree in distribution (the two packages draw different
  random numbers): both means within 0.35 of 0 and both standard
  deviations within 0.3 of 1.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geconpy_torch
from geconpy_torch.stats import checkpoint as port_ckpt
from geconpy_torch.stats.checkpoint import (SamplerCheckpoint,
                                            fit_with_checkpointing,
                                            load_checkpoint, save_checkpoint)
from geconpy_torch.stats.statespace import DSGEStateSpace
from geconpy_tpu.stats import checkpoint as ref_ckpt

RBC = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
           filter_type="stationary", kalman_settle=12)
RUN = dict(num_chains=4, num_warmup=6, num_samples=4, checkpoint_every=2,
           seed=1, max_depth=3, dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _checkpoint(samples: bool) -> SamplerCheckpoint:
    rng = np.random.default_rng(0)
    return SamplerCheckpoint(
        positions=rng.normal(size=(4, 3)),
        step_size=np.array([0.1, 0.2, 0.1, 0.15]),
        inv_mass=np.ones((4, 3)),
        rng_state=torch.Generator().manual_seed(7).get_state().numpy(),
        n_completed=250 if samples else 0,
        param_names=["a", "b", "c"],
        samples=np.zeros((4, 250, 3)) if samples else None,
        logp=rng.normal(size=(4, 250)) if samples else None)


@pytest.mark.parametrize("samples", [True, False])
def test_round_trip(tmp_path, samples):
    ckpt = _checkpoint(samples)
    save_checkpoint(tmp_path / "ckpt", ckpt)
    back = load_checkpoint(tmp_path / "ckpt")
    np.testing.assert_array_equal(back.positions, ckpt.positions)
    np.testing.assert_array_equal(back.step_size, ckpt.step_size)
    np.testing.assert_array_equal(back.rng_state, ckpt.rng_state)
    assert back.rng_state.dtype == np.uint8
    assert back.n_completed == ckpt.n_completed
    assert back.param_names == ["a", "b", "c"]
    if samples:
        assert back.samples.shape == (4, 250, 3)
        np.testing.assert_array_equal(back.logp, ckpt.logp)
    else:
        assert back.samples is None and back.logp is None
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["has_samples"] is samples
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(back.rng_state))
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(7)))


def test_a_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    old = _checkpoint(True)
    save_checkpoint(tmp_path, old)
    # a half-written temporary file from a dead process
    (tmp_path / "arrays.npz.tmp").write_bytes(b"\x00garbage")
    assert load_checkpoint(tmp_path).n_completed == 250

    def dies(fh, **arrays):
        fh.write(b"\x00partial")
        raise OSError("disk gone")

    monkeypatch.setattr(port_ckpt.np, "savez", dies)
    new = _checkpoint(True)
    new.n_completed = 500
    with pytest.raises(OSError, match="disk gone"):
        save_checkpoint(tmp_path, new)
    monkeypatch.undo()
    back = load_checkpoint(tmp_path)
    assert back.n_completed == 250
    np.testing.assert_array_equal(back.positions, old.positions)


@pytest.fixture(scope="module")
def rbc():
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False)
    ss = DSGEStateSpace(model, device="cpu").configure(**RBC)
    data, _ = ss.data_from_prior(torch.Generator().manual_seed(0), periods=48)
    return ss, np.asarray(data)


@pytest.fixture(scope="module")
def unbroken(rbc, tmp_path_factory):
    ss, data = rbc
    return fit_with_checkpointing(ss, data, tmp_path_factory.mktemp("whole"),
                                  **RUN)


def test_stopped_and_resumed_equals_unbroken(rbc, unbroken, tmp_path,
                                             monkeypatch):
    ss, data = rbc
    segment = port_ckpt._segment
    calls = []

    def stops_after_one(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("stopped")
        return segment(*args, **kwargs)

    monkeypatch.setattr(port_ckpt, "_segment", stops_after_one)
    with pytest.raises(KeyboardInterrupt):
        fit_with_checkpointing(ss, data, tmp_path, **RUN)
    assert load_checkpoint(tmp_path).n_completed == 2
    monkeypatch.setattr(port_ckpt, "_segment", segment)
    resumed = fit_with_checkpointing(ss, data, tmp_path, **RUN)
    for key in ("samples", "unconstrained", "logp", "accept_prob",
                "diverging", "step_size"):
        np.testing.assert_array_equal(getattr(resumed, key),
                                      getattr(unbroken, key))
    again = fit_with_checkpointing(ss, data, tmp_path, **RUN)
    np.testing.assert_array_equal(again.samples, unbroken.samples)


def test_diagnostics_come_from_the_transitions(rbc, unbroken):
    ss, data = rbc
    assert unbroken.samples.shape == (4, 4, len(ss.estimated))
    assert np.isfinite(unbroken.samples).all()
    assert np.isfinite(unbroken.logp).all() and (unbroken.logp != 0).any()
    assert ((unbroken.accept_prob >= 0) & (unbroken.accept_prob <= 1)).all()
    assert (unbroken.accept_prob < 1).any()
    assert unbroken.diverging.dtype == bool
    np.testing.assert_allclose(
        unbroken.samples,
        ss.constrain(torch.as_tensor(unbroken.unconstrained)).numpy(),
        rtol=1e-15)
    # the log posterior of each draw is the transition's
    vag = ss.build_logpost_and_grad(data)
    lp, _ = vag(torch.as_tensor(unbroken.unconstrained[:, -1]))
    np.testing.assert_allclose(unbroken.logp[:, -1], lp.numpy(), rtol=1e-12)


class PortTinyTarget:
    """The reference test's Gaussian target, for the port: a batched
    value+grad of -|u|^2/2."""

    param_labels = ["a", "b"]

    def build_logpost_and_grad(self, data):
        return lambda U: (-0.5 * (U * U).sum(-1), -U)

    def initial_position(self, jitter=0.0, generator=None):
        u = torch.zeros(2)
        if jitter and generator is not None:
            u = u + jitter * torch.randn(2, generator=generator)
        return u

    def constrain(self, u):
        return u


class RefTinyTarget:
    """The reference test's own ``TinyTarget``."""

    n_estimated = 2
    param_labels = ["a", "b"]

    def build_logpost(self, data):
        return lambda u: -0.5 * jnp.sum(u**2)

    def initial_position(self, jitter=0.0, key=None):
        u = jnp.zeros(2)
        if jitter and key is not None:
            u = u + jitter * jax.random.normal(key, (2,))
        return u

    def constrain(self, u):
        return u


def test_gaussian_target_in_distribution(tmp_path):
    kw = dict(num_chains=2, num_warmup=100, num_samples=60,
              checkpoint_every=25, seed=0, max_depth=5)
    port = fit_with_checkpointing(PortTinyTarget(), None, tmp_path / "port",
                                  dtype=torch.float64, **kw)
    ref = ref_ckpt.fit_with_checkpointing(RefTinyTarget(), None,
                                          tmp_path / "ref", **kw)
    assert port.samples.shape == np.asarray(ref.samples).shape == (2, 60, 2)
    assert load_checkpoint(tmp_path / "port").n_completed == 60
    for res in (port, ref):
        flat = np.asarray(res.samples).reshape(-1, 2)
        assert np.abs(flat.mean(axis=0)).max() < 0.35
        assert np.abs(flat.std(axis=0) - 1.0).max() < 0.3
    assert (port.accept_prob > 0.3).mean() > 0.9
