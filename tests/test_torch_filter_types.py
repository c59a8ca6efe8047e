"""Port parity: the log posterior of every other ``filter_type``.

``build_logpost`` on ``rbc_estimation`` (Y observed with measurement
error, 48 periods, the generating draw; ``tests/test_torch_filters.py``'s
case) configured with ``filter_type="sequential"``, ``"stationary"`` with
each ``kalman_settle_method`` (``"hewer"``, ``"sda"``, ``"auto"``) and
``"parallel"``, from the unconditional covariance and with
``p0_init="diffuse"``, equals the reference's under ``jax.jit``: value
1e-8, gradient 1e-6.  With ``tests/test_torch_filters.py`` (steady state,
Chandrasekhar)
every filter a user can configure is held to the reference.
"""

import pytest
import torch

from _torch_filter_cases import assert_logpost_matches, rbc_case

CONFIGS = {
    "sequential": dict(filter_type="sequential"),
    "stationary_hewer": dict(filter_type="stationary",
                             kalman_settle_method="hewer"),
    "stationary_sda": dict(filter_type="stationary",
                           kalman_settle_method="sda"),
    "stationary_auto": dict(filter_type="stationary",
                            kalman_settle_method="auto"),
    "parallel": dict(filter_type="parallel"),
    "parallel_diffuse": dict(filter_type="parallel", p0_init="diffuse",
                             diffuse_kappa=1e4, diffuse_presample=2),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


@pytest.fixture(scope="module")
def rbc():
    return rbc_case()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_build_logpost_matches_reference_for_each_filter_type(config, rbc):
    assert_logpost_matches(rbc, CONFIGS[config])
