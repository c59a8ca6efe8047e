"""The port's twin of ``tests/models/test_model_library.py``, part a:
``rbc``, ``rbc_no_ss``, ``rbc_estimation``, ``nk_3eq``, ``nk_full``, ``nk_sw``, ``rbc_two_agent``.

What is checked, and why ``rbc_skilled_unskilled`` has its own bound, is
in ``tests/_torch_model_library.py``.
"""

import pytest
import torch

from _torch_model_library import (SOLVERS, build,
                                  check_policy_matches_reference,
                                  check_solvers_agree)

MODELS = ['rbc', 'rbc_no_ss', 'rbc_estimation', 'nk_3eq', 'nk_full', 'nk_sw', 'rbc_two_agent']


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=MODELS)
def models(request):
    return (request.param,) + build(request.param)


@pytest.mark.parametrize("solver", SOLVERS)
def test_policy_matches_reference(models, solver):
    check_policy_matches_reference(*models, solver)


def test_solvers_agree_on_the_port(models):
    name, _ref, port = models
    check_solvers_agree(name, port)
