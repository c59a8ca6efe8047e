"""Device meshes on the CPU: ``parallel/mesh.py`` and every ``mesh=``.

The port's counterpart of the reference tests' eight virtual CPU devices
is a mesh of eight ``"cpu"`` devices.  Under it:

- ``pvmap`` equals the unsplit call for tensor, tuple, NamedTuple and dict
  outputs, with one function or one per distinct device (built once each);
- ``sharded_prior_sweep`` pads a draw count that does not divide by the
  mesh size and drops the padding;
- ``fit`` (both policies), ``sample_nuts``, ``fit_smc`` and
  ``bk_condition_sweep`` give the results of ``mesh=None`` bit for bit;
  ``solvability_check`` / ``prior_solvability_check`` its flags bit for
  bit, its spectral radii at rel 1e-12 and its residual norms (rounding,
  ~1e-15) at abs 1e-12, and ``prior_predictive_sweep`` its success rate
  and bands at rel 1e-12: on the CPU an elementwise ``pow`` or ``exp`` rounds
  differently in the vectorised body and the scalar tail of ATen's loops,
  so a draw's analytic steady state can move in its last bit with the
  chunk it lands in (1.4e-14 on ``rbc_estimation``'s);
- the reference's divisibility errors, and a mesh whose first device is
  not the state space's, are refused.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import geconpy_torch
from geconpy_torch.parallel import (Mesh, functions_per_device, make_mesh,
                                    pvmap, shard_batch, sharded_prior_sweep)
from geconpy_torch.stats import nuts
from geconpy_torch.stats.prior_predictive import prior_predictive_sweep
from geconpy_torch.stats.statespace import DSGEStateSpace

RBC = dict(observed_states=["Y"], constant_params=["alpha", "sigma_C"],
           filter_type="stationary", kalman_settle=12)
FIT = dict(num_chains=8, num_warmup=3, num_samples=3, max_depth=2,
           dtype=torch.float64, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=("cpu",) * 8)


@pytest.fixture(scope="module")
def setup():
    model = geconpy_torch.model_from_gcn(
        geconpy_torch.get_example_gcn("rbc_estimation"), verbose=False)
    ss = DSGEStateSpace(model, device="cpu").configure(**RBC)
    data, _ = ss.data_from_prior(torch.Generator().manual_seed(0), periods=48)
    return model, ss, np.asarray(data)


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _batched(x):
    return {"sum": x.sum(-1), "pair": Pair(x * 2.0, torch.exp(x[:, :1]))}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return type(a) is type(b) and all(_equal(x, y) for x, y in zip(a, b))


def test_make_mesh(mesh):
    assert mesh.size == 8 and mesh.axis_names == ("batch",)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert make_mesh(3, devices=("cpu",) * 8).size == 3
    assert make_mesh(axis_name="chains", devices=("cpu",)).axis_name == "chains"
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(9, devices=("cpu",) * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_shard_batch(mesh):
    x = torch.arange(32.0).reshape(16, 2)
    chunks = shard_batch(x, mesh)
    assert len(chunks) == 8 and all(c.shape == (2, 2) for c in chunks)
    assert torch.equal(torch.cat(chunks), x)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(x[:12], mesh)
    with pytest.raises(ValueError, match="axis"):
        shard_batch(x, mesh, axis_name="chains")


def test_pvmap_equals_the_unsplit_call(mesh):
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    assert _equal(pvmap(_batched, mesh)(x), _batched(x))
    built = []

    def build(device):
        built.append(device)
        return _batched

    fns = functions_per_device(build, mesh)
    assert built == [torch.device("cpu")]
    assert _equal(pvmap(fns, mesh)(x), _batched(x))
    one = Mesh((torch.device("cpu"),))
    assert _equal(pvmap(_batched, one)(x[:5]), _batched(x[:5]))
    with pytest.raises(ValueError, match="no function"):
        pvmap({torch.device("meta"): _batched}, mesh)


def test_sharded_prior_sweep_pads_and_drops(mesh):
    x = torch.randn(13, 3, generator=torch.Generator().manual_seed(1))
    seen = []

    def fn(chunk):
        seen.append(chunk.shape[0])
        return _batched(chunk)

    out = sharded_prior_sweep(fn, x, mesh)
    assert seen == [2] * 8                      # 13 padded to 16
    assert _equal(out, _batched(x))
    assert out["sum"].shape == (13,)


@pytest.mark.parametrize("policy", ["pallas", "xla"])
def test_fit_under_a_mesh(setup, mesh, policy):
    _model, ss, data = setup
    a = geconpy_torch.fit(ss, data, policy=policy, **FIT)
    b = geconpy_torch.fit(ss, data, policy=policy, mesh=mesh, **FIT)
    for key in ("samples", "logp", "accept_prob", "diverging", "step_size",
                "n_leapfrog", "n_calls"):
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key))


def test_sample_nuts_under_a_mesh(mesh):
    def vag(q):
        return -0.5 * (q * q).sum(-1), -q

    kw = dict(num_warmup=25, num_samples=10, max_depth=4)
    init = torch.linspace(-1, 1, 16).reshape(8, 2)
    a = nuts.sample_nuts(vag, init, torch.Generator().manual_seed(5), **kw)
    b = nuts.sample_nuts(vag, init, torch.Generator().manual_seed(5),
                         mesh=mesh, **kw)
    assert torch.equal(a.samples, b.samples)
    assert torch.equal(a.step_size, b.step_size)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        nuts.sample_nuts(vag, init[:6], torch.Generator(), mesh=mesh, **kw)


def test_fit_smc_under_a_mesh(setup, mesh):
    _model, ss, data = setup
    kw = dict(n_particles=64, n_mh=2, seed=0, policy="pallas",
              settle="fused", resample_ess=0.6, dtype=torch.float64)
    a = geconpy_torch.fit_smc(ss, data, **kw)
    b = geconpy_torch.fit_smc(ss, data, mesh=mesh, mesh_axis="batch",
                              interpret=True, **kw)
    np.testing.assert_array_equal(b.samples, a.samples)
    np.testing.assert_array_equal(b.phi_schedule, a.phi_schedule)
    assert b.log_evidence == a.log_evidence
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        geconpy_torch.fit_smc(ss, data, mesh=mesh, **dict(kw, n_particles=60))
    with pytest.raises(ValueError, match="axis"):
        geconpy_torch.fit_smc(ss, data, mesh=mesh, mesh_axis="chains", **kw)


def test_mesh_must_start_on_the_state_space(setup):
    _model, ss, data = setup
    twin = ss._on_device(torch.device("meta"))
    assert twin is not ss and twin.device == torch.device("meta")
    assert twin.model is ss.model and ss._on_device("cpu") is ss
    assert ss._on_device(torch.device("meta")) is twin
    elsewhere = Mesh((torch.device("meta"), torch.device("cpu")))
    with pytest.raises(ValueError, match="mesh starts on meta"):
        geconpy_torch.fit(ss, data, mesh=elsewhere, **dict(FIT, num_chains=2))


def _assert_table(a, b):
    flags = ("steady_state", "linearization", "policy_solve", "stability",
             "residual_norms", "success")
    assert a.param_names == b.param_names and a.failure_stage == b.failure_stage
    assert torch.equal(a.draws, b.draws)
    for f in flags:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(b.spectral_radius.numpy(),
                               a.spectral_radius.numpy(), rtol=1e-12)
    # the residual norms are rounding (~1e-15) on both sides
    for f in ("deterministic_norm", "stochastic_norm"):
        np.testing.assert_allclose(getattr(b, f).numpy(), getattr(a, f).numpy(),
                                   rtol=0, atol=1e-12)


def test_sweeps_under_a_mesh(setup, mesh):
    model, ss, _data = setup
    draws = {"alpha": np.linspace(0.2, 0.5, 13), "rho_A": np.full(13, 0.9)}
    _assert_table(geconpy_torch.solvability_check(model, draws, device="cpu"),
                  geconpy_torch.solvability_check(model, draws, mesh=mesh))
    _assert_table(
        geconpy_torch.prior_solvability_check(model, n_samples=100,
                                              device="cpu"),
        geconpy_torch.prior_solvability_check(model, n_samples=100,
                                              mesh=mesh))
    a = geconpy_torch.bk_condition_sweep(model, draws, device="cpu")
    b = geconpy_torch.bk_condition_sweep(model, draws, mesh=mesh)
    assert a.param_names == b.param_names
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    kw = dict(n_draws=200, periods=4, fevd_horizon=6, seed=3)
    a = prior_predictive_sweep(ss, **kw)
    b = prior_predictive_sweep(ss, mesh=mesh, **kw)
    assert a.success_rate == b.success_rate
    for x, y in ((a.irf.quantiles, b.irf.quantiles), (a.irf.mean, b.irf.mean),
                 (a.std.quantiles, b.std.quantiles),
                 (a.fevd.values, b.fevd.values)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-12,
                                   atol=1e-15)
