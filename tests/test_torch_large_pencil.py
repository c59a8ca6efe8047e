"""Port parity at the pencil sizes above the small-state K1 and K4.

The plain versions of K1 (``cycle_reduction_policy``) and K4
(``cycle_reduction``) against the reference's Pallas kernels in interpret
mode at 1e-10, on synthetic pencils with a stable solvent from a numpy
seed in float64, at (n, m) = (49, 7), the first n whose small-state CUDA
kernel no longer fits the device's shared memory, and (52, 14), the
two-economy core below.  On the card the wrappers send these shapes to the
large-state kernels (``tests/test_torch_cuda.py`` holds those to the same
plain versions).

End to end: two SW-2007 economies side by side
(``tests/_gcn_fixtures/sw2007_two_economies.gcn``, made by
:func:`two_economies`; 66 variables, 14 shocks), with the 22 parameters
that ``chip_smoke.py`` estimates in each copy (44) and the 7 observables
of each (14).  Its dynamic core is 52 states, so K1 and K4 get (52, 52)
pencils and K1's D has 14 columns.  The port's ``build_batched_loglik(
policy="pallas", settle="pallas")`` on the CPU equals the reference's
with ``interpret=True`` at rel 1e-8, and its stationary
``build_batched_logpost_and_grad(settle="pallas")`` the reference's at
1e-8 / 1e-6, on two draws over 24 periods of the port's data.  CPU,
float64, one thread.
"""

import functools
import os
import pathlib
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geconpy_torch
import geconpy_tpu
from geconpy_torch.ops.batched_cycle_reduction import _cr_plain, _cr_policy_plain
from geconpy_torch.stats.statespace import DSGEStateSpace as PortStateSpace
from geconpy_tpu.ops.pallas_cycle_reduction import (
    pallas_cycle_reduction, pallas_cycle_reduction_policy)
from geconpy_tpu.stats.statespace import DSGEStateSpace as RefStateSpace

FIXTURE = pathlib.Path(__file__).parent / "_gcn_fixtures" \
    / "sw2007_two_economies.gcn"
N_ITER = 14
PENCIL_NM, PENCIL_BATCH = [(49, 7), (52, 14)], 3
SW_EST = ["crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
          "cmap", "cmaw", "cgy", "sigma_ea", "sigma_eb", "sigma_eg",
          "sigma_eqs", "sigma_em", "sigma_epinf", "sigma_ew", "crpi", "crr",
          "cry", "chabb", "csigma"]
SW_OBS = ["y", "c", "inve", "w", "pinf", "r", "lab"]
EST = SW_EST + [p + "_b" for p in SW_EST]
OBS = SW_OBS + [o + "_b" for o in SW_OBS]
PERIODS, SETTLE, BATCH = 24, 8, 2


def two_economies(src: str) -> str:
    """Two copies of the GCN text ``src`` (SW-2007's layout: a header and
    options, one STEADY_STATE block of identities, then the model's
    blocks) in one model: the first copy as it is; the second with every
    variable, parameter and shock name suffixed ``_b`` and every block
    renamed ``*_B``; both copies' steady-state identities in the one
    STEADY_STATE block (a second block of that name would be read as
    dynamic equations)."""
    ss = re.search(r"block STEADY_STATE\n\{\n    identities\n    \{\n"
                   r"(.*?\n)    \};\n\};\n", src, re.S)
    head, identities, blocks = src[:ss.start()], ss.group(1), src[ss.end():]
    # variables and shocks (x[...]) and the calibrated parameters (x ~ or
    # x = at the start of a statement)
    names = set(re.findall(r"\b([A-Za-z_]\w*)\[", src)) | set(
        re.findall(r"^\s*([A-Za-z_]\w*)\s*[~=]", blocks, re.M))
    pattern = re.compile(
        r"\b(" + "|".join(sorted(names, key=len, reverse=True)) + r")\b")

    def rename(text):
        return pattern.sub(r"\1_b", text)

    blocks_b = re.sub(r"^block (\w+)$", r"block \1_B", rename(blocks),
                      flags=re.M)
    return (head + "block STEADY_STATE\n{\n    identities\n    {\n"
            + identities + rename(identities) + "    };\n};\n" + blocks
            + blocks_b)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu_float64():
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _stable_pencil(n, m, batch, seed):
    """numpy float64 (A, B, C, D) with A + B T + C T^2 = 0 for a T of
    spectral radius 0.8 (``tests/test_torch_cycle_reduction.py``'s
    pencils)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((batch, n, n))
    T *= 0.8 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    C = 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    M = 2.0 * np.eye(n) + 0.3 * rng.standard_normal((batch, n, n)) / np.sqrt(n)
    D = rng.standard_normal((batch, n, m))
    return -M @ T, M - C @ T, C, D


@pytest.mark.parametrize("n,m", PENCIL_NM)
def test_plain_kernels_match_pallas_interpret_at_large_pencils(n, m):
    """K1's plain version (T, R, the residual) and K4's (T) against the
    reference's kernels in interpret mode at 1e-10; every draw solved by
    both."""
    pencil = _stable_pencil(n, m, PENCIL_BATCH, seed=n + m)
    T_r, R_r, ok_r, resid_r = jax.jit(functools.partial(
        pallas_cycle_reduction_policy, n_iter=N_ITER, tile=PENCIL_BATCH,
        interpret=True))(*(jnp.asarray(p) for p in pencil))
    T, R, flags = _cr_policy_plain(*(torch.as_tensor(p) for p in pencil),
                                   N_ITER)
    assert np.asarray(ok_r).all()
    assert _rel(T.numpy(), T_r) < 1e-10 and _rel(R.numpy(), R_r) < 1e-10
    assert _rel(flags[:, 2].numpy(), resid_r) < 1e-10
    T4_r, ok4_r = jax.jit(functools.partial(
        pallas_cycle_reduction, n_iter=N_ITER, tile=PENCIL_BATCH,
        interpret=True))(*(jnp.asarray(p) for p in pencil[:3]))
    T4, flags4 = _cr_plain(*(torch.as_tensor(p) for p in pencil[:3]), N_ITER)
    assert np.asarray(ok4_r).all()
    assert bool(((flags4[:, 1] < 200 * np.finfo(np.float64).eps)
                 & (flags4[:, 0] > 1e-7)).all())
    assert _rel(T4.numpy(), T4_r) < 1e-10


def test_fixture_is_two_renamed_sw2007_economies():
    """Below its header comment the fixture is :func:`two_economies` of the
    bundled ``sw2007.gcn``; the model has twice SW-2007's variables and
    shocks, and each name of the second economy is a name of the first
    with ``_b`` appended."""
    header, body = FIXTURE.read_text().split("\n\n", 1)
    assert all(line.startswith("#") for line in header.splitlines())
    src = geconpy_torch.get_example_gcn("sw2007")
    assert body == two_economies(src)
    one = geconpy_torch.model_from_gcn(src, verbose=False)
    two = geconpy_torch.model_from_gcn(body, verbose=False)
    assert two.functions.n_variables == 2 * one.functions.n_variables == 66
    assert two.functions.n_shocks == 2 * one.functions.n_shocks == 14
    for names in (two.functions.shock_names, two.param_names):
        second = {x for x in names if x.endswith("_b")}
        assert {x[:-2] for x in second} == set(names) - second


def _configure(names, filter_type):
    return dict(observed_states=OBS, filter_type=filter_type,
                kalman_settle=SETTLE,
                constant_params=[p for p in names if p not in EST])


@pytest.fixture(scope="module")
def two_sw():
    """Both packages' two-economy model, data (PERIODS, 14) from the
    port's ``data_from_prior`` under a CPU generator, and two draws near
    its generating point."""
    src = FIXTURE.read_text()
    ref_model = geconpy_tpu.model_from_gcn(src, verbose=False)
    port_model = geconpy_torch.model_from_gcn(src, verbose=False)
    ref_ss = RefStateSpace(ref_model).configure(
        **_configure(ref_model.param_names, "steady_state"))
    port_ss = PortStateSpace(port_model, device="cpu").configure(
        **_configure(port_model.param_names, "steady_state"))
    assert port_ss.param_labels == ref_ss.param_labels
    assert len(port_ss.param_labels) == len(EST)
    data, draw = port_ss.data_from_prior(torch.Generator().manual_seed(0),
                                         periods=PERIODS)
    u0 = port_ss.unconstrain(draw).numpy()
    U = u0[None] + 0.05 * np.random.default_rng(1).standard_normal(
        (BATCH, u0.shape[0]))
    return ref_model, port_model, ref_ss, port_ss, np.asarray(data), U


def test_two_economies_core_is_52(two_sw):
    """The reduced core of 52 states: K1's pencil (B, 52, 52) with D of
    (B, 52, 14) on the sweep, K4's (B, 52, 52) on the value+grad path, and
    a filter state of 52 with 14 observables for K2."""
    _ref_model, port_model, _ref_ss, port_ss, data, U = two_sw
    assert len(port_ss._filter_core) == 52
    record: dict = {}
    port_ss.build_batched_loglik(data, n_settle=SETTLE, policy="pallas",
                                 settle="pallas")(torch.as_tensor(U),
                                                  record=record)
    A, B, C, D = record["cycle_reduction_policy"]
    assert A.shape == B.shape == C.shape == (BATCH, 52, 52)
    assert D.shape == (BATCH, 52, 14)
    _y, T_aug, _RQR, Z, _H, _d = record["settle_parts"]
    assert T_aug.shape == (BATCH, 52, 52) and Z.shape == (BATCH, 14, 52)
    port_st = PortStateSpace(port_model, device="cpu").configure(
        **_configure(port_model.param_names, "stationary"))
    record = {}
    port_st.build_batched_logpost(data, settle="pallas")(
        torch.as_tensor(U), record=record)
    assert all(X.shape == (BATCH, 52, 52)
               for X in record["cycle_reduction"])


def test_two_economies_sweep_matches_reference(two_sw):
    _ref_model, _port_model, ref_ss, port_ss, data, U = two_sw
    want = np.asarray(jax.jit(ref_ss.build_batched_loglik(
        data, n_settle=SETTLE, policy="pallas", settle="pallas", cr_tile=8,
        interpret=True))(jnp.asarray(U)))
    got = port_ss.build_batched_loglik(
        data, n_settle=SETTLE, policy="pallas", settle="pallas")(
        torch.as_tensor(U))
    assert _rel(got.numpy(), want) < 1e-8


def test_two_economies_value_and_grad_match_reference(two_sw):
    """The stationary filter's value+grad with ``settle="pallas"`` (K4,
    then K6): values at rtol/atol 1e-8, gradients at 1e-6, the bars of
    ``tests/test_torch_logpost_grad.py``."""
    ref_model, port_model, _ref_ss, _port_ss, data, U = two_sw
    ref_st = RefStateSpace(ref_model).configure(
        **_configure(ref_model.param_names, "stationary"))
    port_st = PortStateSpace(port_model, device="cpu").configure(
        **_configure(port_model.param_names, "stationary"))
    v_ref, g_ref = (np.asarray(x) for x in jax.jit(
        ref_st.build_batched_logpost_and_grad(
            data, interpret=True, cr_tile=8, settle="pallas"))(
        jnp.asarray(U)))
    v, g = port_st.build_batched_logpost_and_grad(data, settle="pallas")(
        torch.as_tensor(U))
    assert np.isfinite(v_ref).all()
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6, atol=1e-6)
