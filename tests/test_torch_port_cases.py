"""The port's three cases against the JAX package's, on the CPU: the case
tables, the bundled datasets, the full and partial physics models on the
same inputs, the oscillator physics, and ``sample_response``.

Physics tolerance rtol/atol 1e-5: both sides are f32 models of the same
arithmetic, and the outputs are of order 1 (oscillator displacement,
bridge strain); simple_beam's deflections run to about 25 mm, where its
atol is 1e-4, as in tests/test_torch_port_ops.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.cases import list_cases as jax_list_cases
from dpivae_tpu.physics import mass_spring as jax_mass_spring
from dpivae_tpu.physics import mass_spring_dashpot as jax_mass_spring_dashpot
from dpivae_tpu_torch.cases import get_case, list_cases
from dpivae_tpu_torch.physics import mass_spring, mass_spring_dashpot
from dpivae_tpu_torch.utils.data import sample_response

CASES = ["bridge", "damped_oscillator", "simple_beam"]
ATOL = {"bridge": 1e-5, "damped_oscillator": 1e-5, "simple_beam": 1e-4}


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _uniform_factors(case, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(f.args["low"], f.args["high"], shape)
                     for f in case.factors], -1).astype(np.float32)


def test_list_cases_matches_jax():
    assert list(list_cases()) == CASES == list(jax_list_cases())


@pytest.mark.parametrize("name", CASES)
def test_case_tables_match_jax(name):
    jcase, case = jax_get_case(name), get_case(name)
    for attr in ("name", "shapes", "idx_c_phys", "z_idx_x", "z_idx_c",
                 "z_idx_y", "nd_x", "t_min", "t_max", "sigma_x", "sigma_c",
                 "sigma_y", "x_unit", "y_unit", "ylim"):
        assert getattr(case, attr) == getattr(jcase, attr), attr
    assert [vars(f) for f in case.factors] == [vars(f) for f in jcase.factors]
    assert [vars(p) for p in case.prior_x] == [vars(p) for p in jcase.prior_x]
    assert dict(case.presets) == dict(jcase.presets)
    np.testing.assert_array_equal(case.t, jcase.t)
    for attr in ("x_full", "y_full", "x_part", "y_part"):
        got, want = getattr(case, attr), getattr(jcase, attr)
        assert (got is None) == (want is None), attr
        if want is not None:
            np.testing.assert_array_equal(got, want)


def test_bridge_has_the_one_physical_covariate():
    case = get_case("bridge")
    assert case.idx_c_phys == (1,) and case.nd_p == 1
    assert case.part_model.scaler_mean.shape == (1, case.nz_x + 1)
    widths = [layer["w"].shape for layer in case.part_model.params["layers"]]
    assert widths == [(3, 64), (64, 32), (32, 64), (64, 64)]


@pytest.mark.parametrize("name", CASES)
def test_full_model_matches_jax(name):
    jcase, case = jax_get_case(name), get_case(name)
    z = _uniform_factors(jcase, (5, 13), 1)
    _close(case.full_model(_t(z)), jcase.full_model(jnp.asarray(z)),
           atol=ATOL[name])


@pytest.mark.parametrize("name", CASES)
def test_part_model_matches_jax(name):
    """Each case's partial physics on z_x, with the raw physical covariates
    joined as the decoder joins them (bridge's delta_xs)."""
    jcase, case = jax_get_case(name), get_case(name)
    z = _uniform_factors(jcase, (5, 13), 2)
    c_idx = [jcase.z_idx_c[i] for i in jcase.idx_c_phys]
    zx_in = z[..., list(jcase.z_idx_x) + c_idx]
    got = case.part_model(_t(zx_in))
    assert got.shape == (5, 13, case.nd_x)
    _close(got, jcase.part_model(jnp.asarray(zx_in)), atol=ATOL[name])


def test_mass_spring_matches_jax():
    rng = np.random.default_rng(3)
    z = rng.uniform(1.0, 2.0, (6, 11, 1)).astype(np.float32)
    t = np.linspace(0.0, 9.95, 64).astype(np.float32)
    got = mass_spring(_t(z), _t(t))
    assert got.shape == (6, 11, 64)
    _close(got, jax_mass_spring(jnp.asarray(z), jnp.asarray(t)))


def test_mass_spring_dashpot_matches_jax():
    jcase = jax_get_case("damped_oscillator")
    z = _uniform_factors(jcase, (6, 11), 4)
    t = np.linspace(0.0, 9.95, 64).astype(np.float32)
    got = mass_spring_dashpot(_t(z), _t(t))
    _close(got, jax_mass_spring_dashpot(jnp.asarray(z), jnp.asarray(t)))
    # A numpy time grid is taken to z's device and dtype.
    _close(mass_spring_dashpot(_t(z), t), got, atol=0, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_sample_response_shapes(name):
    case = get_case(name)
    nz_x, nd_c, nd_y, nd_f, _ = case.shapes
    x, c, y, z = sample_response(case, torch.Generator().manual_seed(0), 50,
                                 sample_dist=case.gt_dist(), device="cpu")
    assert x.shape == (50, case.nd_x) and c.shape == (50, nd_c)
    assert y.shape == (50, nd_y) and z.shape == (50, nz_x + nd_c + nd_y + nd_f)
    assert all(torch.isfinite(a).all() for a in (x, c, y, z))
    lo = torch.tensor([f.args["low"] for f in case.factors])
    hi = torch.tensor([f.args["high"] for f in case.factors])
    assert bool(((z >= lo) & (z <= hi)).all())


def test_frozen_physics_first_called_in_inference_mode_trains():
    """The physics keeps its constants on the device after a first call;
    a first call under inference mode (a Predictor) must not leave
    inference tensors that a later training step cannot differentiate
    through."""
    for name in ("bridge", "damped_oscillator"):
        # A copy holds no device constants yet
        part = dataclasses.replace(get_case(name).part_model)
        width = 3 if name == "bridge" else 1
        z = torch.full((4, width), 1.5)
        with torch.inference_mode():
            part(z)
        zg = z.clone().requires_grad_()
        part(zg).sum().backward()
        assert zg.grad is not None and torch.isfinite(zg.grad).all()


def test_unknown_case_lists_all_three():
    with pytest.raises(KeyError, match="bridge.*damped_oscillator.*simple_beam"):
        get_case("no_such_case")
