"""Port parity: ``geconpy_torch/models/validation.py``.

- ``evaluate_steady_state_residuals`` at the same candidate steady state
  (the reference's solved one, by name) equals the reference's residuals
  at rel 1e-10 (within 1e-12 where they are rounding), on ``rbc``, on
  ``rbc_estimation`` with a calibrated parameter, and with parameter
  updates.
- ``check_steady_state`` is True on ``rbc`` and on ``open_rbc`` (whose
  steady state is numeric) as the port solves them, and False on a
  perturbed steady state, logging the same failing equations and residuals
  as the reference (the reference's ``tests/test_public_api.py`` cases).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import logging
import re

import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.models import validation as port
from geconpy_tpu.models import validation as ref


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _models(name):
    return (geconpy_tpu.model_from_gcn(geconpy_tpu.get_example_gcn(name),
                                       verbose=False),
            geconpy_torch.model_from_gcn(geconpy_torch.get_example_gcn(name),
                                         verbose=False))


@pytest.mark.parametrize("name,updates", [("rbc", {}),
                                          ("rbc", {"beta": 0.98}),
                                          ("rbc_estimation", {})])
def test_residuals_match_reference(name, updates):
    ref_model, port_model = _models(name)
    ss = {str(k): float(v) for k, v in
          ref_model.steady_state(verbose=False, **updates).items()}
    want = ref.evaluate_steady_state_residuals(ref_model, ss, **updates)
    got = port.evaluate_steady_state_residuals(port_model, ss, **updates)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # a wrong candidate: the residuals are no longer rounding
    bad = dict(ss, **{next(iter(ss)): ss[next(iter(ss))] * 1.1})
    np.testing.assert_allclose(
        port.evaluate_steady_state_residuals(port_model, bad, **updates),
        ref.evaluate_steady_state_residuals(ref_model, bad, **updates),
        rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["rbc", "open_rbc"])
def test_solved_steady_state_passes(name):
    _, port_model = _models(name)
    assert port.check_steady_state(port_model, device="cpu") is True
    assert geconpy_torch.check_steady_state(port_model, device="cpu") is True


def test_perturbed_steady_state_fails_and_logs_as_the_reference(caplog):
    ref_model, port_model = _models("rbc")
    ss = {str(k): float(v) for k, v in
          ref_model.steady_state(verbose=False).items()}
    bad = dict(ss)
    first = next(iter(bad))
    bad[first] = bad[first] + 1.0
    logs = {}
    for tag, module, model in (("ref", ref, ref_model),
                               ("port", port, port_model)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=module.__name__):
            assert module.check_steady_state(model, steady_state=bad) is False
        logs[tag] = [r.getMessage() for r in caplog.records]
    assert "NOT successful" in logs["port"][0]
    assert len(logs["port"]) == len(logs["ref"]) > 1
    # equations print as sympy does in both; residuals to the printed digits
    numbers = re.compile(r"-?\d+\.?\d*(e[-+]\d+)?")
    for a, b in zip(logs["port"], logs["ref"]):
        assert numbers.sub("#", a) == numbers.sub("#", b)
        np.testing.assert_allclose(
            [float(m.group()) for m in numbers.finditer(a)],
            [float(m.group()) for m in numbers.finditer(b)], rtol=1e-5)
