"""dpivae_tpu_torch's math against dpivae_tpu's, on the CPU: the fused MLP
with its backward (the hidden recompute and the autograd function), MVN
sampling and density, gradient reversal, transforms with their
log-dets, beam physics, the frozen surrogate and the distributions.

Inputs come from numpy with a seed and go through both packages. Unless a
test says otherwise the tolerance is rtol 1e-5 / atol 1e-5: both sides are
f32 and differ only in the order of their sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.ops import gradrev as jax_gradrev
from dpivae_tpu.ops import mvn as jax_mvn
from dpivae_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from dpivae_tpu.physics import euler_bernoulli_point_load as jax_beam
from dpivae_tpu.utils import distributions as jax_dist
from dpivae_tpu.utils import transforms as jax_tf
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import mvn
from dpivae_tpu_torch.ops.fused_mlp import (
    FusedMLPFunction,
    fused_mlp,
    fused_mlp_hidden,
    fused_mlp_hidden_reference,
    fused_mlp_on_path,
    fused_mlp_reference,
)
from dpivae_tpu_torch.ops.gradrev import grad_reverse, maybe_grad_reverse
from dpivae_tpu_torch.physics import euler_bernoulli_point_load
from dpivae_tpu_torch.utils import distributions as dist
from dpivae_tpu_torch.utils import transforms as tf

RTOL = ATOL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _mlp_inputs(lead, d_in=4, d_hidden=128, d_out=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(*lead, d_in), f(d_in, d_hidden) * 0.3, f(d_hidden) * 0.1,
            f(d_hidden, d_out) * 0.3, f(d_out) * 0.1)


@pytest.mark.parametrize("lead", [(1000,), (8, 125), (2, 5, 100)])
def test_fused_mlp_matches_jax(lead):
    x, w0, b0, w1, b1 = _mlp_inputs(lead)
    want = jax_fused_mlp(*(jnp.asarray(a) for a in (x, w0, b0, w1, b1)))
    # The port keeps weights in nn.Linear (out, in) layout.
    got = fused_mlp(_t(x), _t(w0.T), _t(b0), _t(w1.T), _t(b1))
    assert got.shape == (*lead, 32)
    _close(got, want)


def test_fused_mlp_cpu_is_the_plain_version_and_counts_nothing():
    args = [_t(a) for a in _mlp_inputs((64,), d_hidden=256)]
    args[1], args[3] = args[1].T.contiguous(), args[3].T.contiguous()
    before = fused_mlp.launches
    assert torch.equal(fused_mlp(*args), fused_mlp_reference(*args))
    assert fused_mlp.launches == before


def test_fused_mlp_cpu_gradient_flows():
    x, w0, b0, w1, b1 = _mlp_inputs((32,))
    fn = lambda *a: jnp.sum(jax_fused_mlp(*a) ** 2)
    want = jax.grad(fn, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, w0, b0, w1, b1)))
    tx, tw0, tb0, tw1, tb1 = (
        _t(a).requires_grad_() for a in (x, w0.T, b0, w1.T, b1))
    torch.sum(fused_mlp(tx, tw0, tb0, tw1, tb1) ** 2).backward()
    for got, ref in zip((tx.grad, tw0.grad.T, tb0.grad, tw1.grad.T, tb1.grad),
                        want):
        _close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lead", [(64,), (4, 16)])
def test_fused_mlp_function_matches_jax_custom_vjp(lead):
    """FusedMLPFunction's forward and backward against the JAX fused_mlp's
    custom VJP (_fused_mlp_fwd/_fused_mlp_bwd) for one cotangent. On the
    CPU both recompute the hidden layer with their plain versions."""
    x, w0, b0, w1, b1 = _mlp_inputs(lead)
    g = np.random.default_rng(9).standard_normal((*lead, 32)).astype(np.float32)
    want_y, vjp = jax.vjp(jax_fused_mlp,
                          *(jnp.asarray(a) for a in (x, w0, b0, w1, b1)))
    want = vjp(jnp.asarray(g))
    args = [_t(a).requires_grad_() for a in (x, w0.T, b0, w1.T, b1)]
    y = FusedMLPFunction.apply(*args)
    assert type(y.grad_fn).__name__ == "FusedMLPFunctionBackward"
    _close(y, want_y)
    grads = torch.autograd.grad(y, args, _t(g))
    for got, ref in zip((grads[0], grads[1].T, grads[2], grads[3].T, grads[4]),
                        want):
        assert got.shape == ref.shape
        _close(got, ref, rtol=1e-4, atol=1e-5)
    # fused_mlp takes the autograd function exactly when a gradient is
    # needed, and the plain forward otherwise.
    assert type(fused_mlp(*args).grad_fn).__name__ == "FusedMLPFunctionBackward"
    with torch.no_grad():
        assert fused_mlp(*args).grad_fn is None


@pytest.mark.parametrize("lead", [(1000,), (8, 125)])
def test_fused_mlp_hidden_matches_jax_plain_math(lead):
    """The recompute against the plain branch of _fused_mlp_bwd, the math of
    _pallas_hidden: relu(x @ w0 + b0)."""
    x, w0, b0, _, _ = _mlp_inputs(lead)
    want = jnp.maximum(jnp.asarray(x) @ jnp.asarray(w0) + jnp.asarray(b0), 0.0)
    before = fused_mlp_hidden.launches
    got = fused_mlp_hidden(_t(x), _t(w0.T), _t(b0))
    assert got.shape == (*lead, 128)
    _close(got, want)
    assert torch.equal(got, fused_mlp_hidden_reference(_t(x), _t(w0.T), _t(b0)))
    assert fused_mlp_hidden.launches == before


def test_fused_mlp_rejects_other_devices():
    args = [_t(a).to("meta") for a in _mlp_inputs((4,))]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_mlp(*args)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_mlp_hidden(*args[:3])


@pytest.mark.parametrize("staged", [False, True])
def test_fused_mlp_on_path_takes_only_cuda_tensors(staged):
    """Forcing a kernel path means nothing for the plain version: a CPU
    tensor raises instead of running it, and nothing is counted."""
    args = [_t(a) for a in _mlp_inputs((4,))]
    before = fused_mlp.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mlp_on_path(*args, staged=staged)
    assert fused_mlp.launches == before


def _tf32(t):
    """``cvt.rna.tf32.f32`` in plain torch: the f32 mantissa rounded to
    TF32's 10 bits, to nearest with ties away from zero (adding half of the
    13 dropped bits' unit to the magnitude, then clearing them)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(t):
    """What a tensor core reads of an f32 register given as TF32: the low
    13 mantissa bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def test_tf32_emulation_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    for v, want in [(1 + ulp / 2, 1 + ulp), (1 + ulp / 2 - 2.0 ** -20, 1.0),
                    (-(1 + ulp / 2), -(1 + ulp)), (1 + 3 * ulp / 4, 1 + ulp)]:
        assert float(_tf32(one * v)) == want
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert (_tf32(x).view(torch.int32) & 0x1FFF == 0).all()
    assert ((_tf32(x) - x).abs() <= x.abs() * 2.0 ** -11).all()


def _split_layer2(h, w1, b1, k_group=8):
    """Layer 2 of the forward kernel in the 3xTF32 split, on an f32 model:
    h and W1 split into hi = tf32(v) (rounded) and lo = v - hi (read
    truncated to TF32 by the tensor cores); the cross terms lo*hi + hi*lo
    of every 8-wide k step chained into one f32 sum (small), the hi*hi
    products of each k_group hidden units summed from zero and added to an
    f32 total that starts at b1 (big). Products of two TF32 values are
    exact in f32. Returns (big, small)."""
    h_hi, w_hi = _tf32(h), _tf32(w1)
    h_lo, w_lo = _tf32_truncated(h - h_hi), _tf32_truncated(w1 - w_hi)
    big = b1.expand(h.shape[0], w1.shape[1]).clone()
    small = torch.zeros_like(big)
    for k in range(0, h.shape[1], 8):
        s = slice(k, k + 8)
        small += h_lo[:, s] @ w_hi[s]
        small += h_hi[:, s] @ w_lo[s]
    for k in range(0, h.shape[1], k_group):
        s = slice(k, k + k_group)
        big += h_hi[:, s] @ w_hi[s]
    return big, small


def test_3xtf32_split_meets_f32_tolerance_and_one_pass_does_not():
    """The forward kernel's layer 2 emulated on the CPU: h and W1 split into
    hi = tf32(v) (rounded) and lo = v - hi (read truncated to TF32 by the
    tensor cores); for each 8-wide k step the hi*hi product is added to an
    f32 total and the cross terms lo*hi + hi*lo to a second one (products
    of two TF32 values are exact in f32). Against the float64 result at
    2,048 x (4 -> 128 -> 32) with the CUDA tests' weight scales the split
    holds rtol/atol 1e-5; one TF32 pass (hi*hi) does not, which is why the
    kernel pays three."""
    x, w0, b0, w1, b1 = (_t(a) for a in _mlp_inputs((2048,)))
    h = torch.relu(x @ w0 + b0)   # layer 1 in f32, as in the kernel
    want = h.double() @ w1.double() + b1.double()
    big, small = _split_layer2(h, w1, b1)
    split, one_pass = big + small, big
    assert torch.allclose(split.double(), want, rtol=RTOL, atol=ATOL)
    assert float((split.double() - want).abs().max()) < 1e-5
    assert not torch.allclose(one_pass.double(), want, rtol=RTOL, atol=ATOL)
    assert float((one_pass.double() - want).abs().max()) > 1e-3


# The hi*hi groupings the forward kernel sums from zero: one 8-wide k step
# (a wgmma or mma.sync k8 step), on both paths.
@pytest.mark.parametrize("k_group", [8])
def test_3xtf32_accumulation_meets_float64_at_h256(k_group):
    """The forward kernel's layer-2 accumulation on the f32 model of
    ``_split_layer2`` at 2,048 x (4 -> 256 -> 32) with W1 at scale 0.3, so
    that outputs spread as sqrt(H) (chip_smoke.py's float64 check holds
    the kernel itself there): within rtol/atol 1e-5 of float64."""
    x, w0, b0, w1, b1 = (_t(a) for a in _mlp_inputs((2048,), d_hidden=256))
    h = torch.relu(x @ w0 + b0)
    want = h.double() @ w1.double() + b1.double()
    big, small = _split_layer2(h, w1, b1, k_group)
    got = (big + small).double()
    assert torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    assert float((got - want).abs().max()) < 1e-5


def _tril(rng, lead, d):
    L = np.tril(rng.standard_normal((*lead, d, d)), k=-1) * 0.3
    diag = np.exp(rng.uniform(-1.0, 1.0, (*lead, d)))
    return (L + diag[..., None] * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("d", [2, 6, 20])
def test_mvn_sample_with_log_prob_matches_jax(d):
    rng = np.random.default_rng(d)
    n, lead = 5, (3, 4)
    loc = rng.standard_normal((*lead, d)).astype(np.float32)
    tril = _tril(rng, lead, d)
    key = jax.random.PRNGKey(d)
    # Replay the normals the JAX sampler draws from its key (mvn.py:65).
    eps = np.asarray(jax.random.normal(key, (n, *lead, d)))
    z_j, lq_j = jax_mvn.mvn_sample_with_log_prob(
        key, jnp.asarray(loc), jnp.asarray(tril), n)
    z, lq = mvn.mvn_sample_with_log_prob(_t(loc), _t(tril), n, eps=_t(eps))
    _close(z, z_j)
    _close(lq, lq_j)


@pytest.mark.parametrize("d", [2, 6, 20])
def test_mvn_log_prob_matches_jax(d):
    rng = np.random.default_rng(100 + d)
    lead = (3, 4)
    z = rng.standard_normal((5, *lead, d)).astype(np.float32)
    loc = rng.standard_normal((*lead, d)).astype(np.float32)
    tril = _tril(rng, lead, d)
    want = jax_mvn.mvn_log_prob(jnp.asarray(z), jnp.asarray(loc),
                                jnp.asarray(tril))
    _close(mvn.mvn_log_prob(_t(z), _t(loc), _t(tril)), want, rtol=1e-4)


def test_mvn_sampler_needs_generator_or_eps():
    loc, tril = torch.zeros(3, 2), torch.eye(2).expand(3, 2, 2)
    with pytest.raises(ValueError, match="Generator"):
        mvn.mvn_sample_with_log_prob(loc, tril, 4)
    with pytest.raises(ValueError, match="expected"):
        mvn.mvn_sample_with_log_prob(loc, tril, 4, eps=torch.zeros(4, 3, 3))
    z, _ = mvn.mvn_sample_with_log_prob(
        loc, tril, 4, generator=torch.Generator().manual_seed(0))
    assert z.shape == (4, 3, 2)


@pytest.mark.parametrize("alpha", [1 / 256, 0.5, -1.0])
def test_grad_reverse_matches_jax(alpha):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        jnp.asarray(w) * jnp.sin(jax_gradrev.grad_reverse(a, alpha))
    ))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = grad_reverse(tx, alpha)
    _close(y, x, rtol=0, atol=0)
    torch.sum(_t(w) * torch.sin(y)).backward()
    _close(tx.grad, want)


def test_maybe_grad_reverse_none_is_identity():
    x = torch.randn(3, generator=torch.Generator().manual_seed(0))
    assert maybe_grad_reverse(x, None) is x


def _transform_pairs():
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((50, 5)) * 3 + 1).astype(np.float32)
    lb = np.array([2.0, 0.01], np.float32)
    ub = np.array([6.0, 0.99], np.float32)
    jlb, jub, tlb, tub = jnp.asarray(lb), jnp.asarray(ub), _t(lb), _t(ub)
    return {
        "standard_scaler": (jax_tf.StandardScaler.fit(jnp.asarray(data)),
                            tf.StandardScaler.fit(_t(data)), 5),
        "shift_scale": (jax_tf.ShiftScale(jlb, jub), tf.ShiftScale(tlb, tub), 2),
        "logistic": (jax_tf.Logistic(k=1.5), tf.Logistic(k=1.5), 2),
        "chain": (jax_tf.Chain(jax_tf.Logistic(1.0), jax_tf.ShiftScale(jlb, jub)),
                  tf.Chain(tf.Logistic(1.0), tf.ShiftScale(tlb, tub)), 2),
        "masked_chain": (
            jax_tf.MaskedChain((0, 1), jax_tf.Logistic(1.0),
                               jax_tf.ShiftScale(jlb, jub)),
            tf.MaskedChain((0, 1), tf.Logistic(1.0), tf.ShiftScale(tlb, tub)),
            6),
    }


@pytest.mark.parametrize("name", list(_transform_pairs()))
def test_transform_forward_matches_jax(name):
    jt, tt, d = _transform_pairs()[name]
    z = np.random.default_rng(1).standard_normal((4, 3, d)).astype(np.float32)
    out_j, ld_j = jt.forward(jnp.asarray(z))
    out, ld = tt.forward(_t(z))
    _close(out, out_j)
    _close(ld, ld_j)


@pytest.mark.parametrize("name", ["standard_scaler", "shift_scale"])
def test_transform_inverse_matches_jax(name):
    jt, tt, d = _transform_pairs()[name]
    z = np.random.default_rng(2).standard_normal((4, 3, d)).astype(np.float32)
    out_j, ld_j = jt.inverse(jnp.asarray(z))
    out, ld = tt.inverse(_t(z))
    _close(out, out_j)
    _close(ld, ld_j)


def test_beam_physics_matches_jax():
    rng = np.random.default_rng(3)
    z = np.stack([rng.uniform(2.0, 6.0, (7, 9)),
                  rng.uniform(0.01, 0.99, (7, 9))], -1).astype(np.float32)
    want = jax_beam(jnp.asarray(z), npts=32)
    # Deflections run to ~25 mm: rtol 1e-5 on them is a few f32 ulps.
    _close(euler_bernoulli_point_load(_t(z), npts=32), want, atol=1e-4)


def _factor_samples(factors, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(f.args["low"], f.args["high"], n)
                     for f in factors], -1).astype(np.float32)


def test_surrogate_matches_jax():
    jcase, case = jax_get_case("simple_beam"), get_case("simple_beam")
    z = _factor_samples(jcase.factors, 64, 4)
    _close(case.full_model(_t(z)), jcase.full_model(jnp.asarray(z)),
           atol=1e-4)


def test_case_tables_match_jax():
    jcase, case = jax_get_case("simple_beam"), get_case("simple_beam")
    for name in ("shapes", "idx_c_phys", "z_idx_x", "z_idx_c", "z_idx_y",
                 "nd_x", "sigma_x", "sigma_c", "sigma_y", "ylim"):
        assert getattr(case, name) == getattr(jcase, name), name
    assert [vars(f) for f in case.factors] == [vars(f) for f in jcase.factors]
    assert [vars(p) for p in case.prior_x] == [vars(p) for p in jcase.prior_x]
    assert dict(case.presets) == dict(jcase.presets)
    np.testing.assert_array_equal(case.t, jcase.t)


def test_unknown_case_lists_available():
    with pytest.raises(KeyError, match="simple_beam"):
        get_case("no_such_case")


@pytest.mark.parametrize("spec", [
    ("normal", dict(loc=0.5, scale=0.2)),
    ("uniform", dict(low=-11.0, high=5.0)),
])
def test_distribution_matches_jax(spec):
    name, args = spec
    jd, td = jax_dist.make_distribution(name, **args), dist.make_distribution(name, **args)
    rng = np.random.default_rng(5)
    z = rng.uniform(-15.0, 15.0, 200).astype(np.float32)
    u = rng.uniform(0.01, 0.99, 200).astype(np.float32)
    _close(td.log_prob(_t(z)), jd.log_prob(jnp.asarray(z)))
    _close(td.icdf(_t(u)), jd.icdf(jnp.asarray(u)), atol=1e-4)
    _close(td.cdf(_t(z)), jd.cdf(jnp.asarray(z)))


@pytest.mark.parametrize("which", ["gt_dist", "prior_x_dist"])
def test_marginal_distribution_matches_jax(which):
    jd = getattr(jax_get_case("simple_beam"), which)()
    td = getattr(get_case("simple_beam"), which)()
    rng = np.random.default_rng(6)
    z = rng.uniform(0.0, 1.0, (3, 10, td.n_z)).astype(np.float32)
    u = rng.uniform(0.01, 0.99, (10, td.n_z)).astype(np.float32)
    _close(td.log_prob(_t(z)), jd.log_prob(jnp.asarray(z)))
    _close(td.icdf(_t(u)), jd.icdf(jnp.asarray(u)), atol=1e-4)
    s = td.sample(torch.Generator().manual_seed(0), (5000,))
    assert s.shape == (5000, td.n_z)
    assert torch.isfinite(td.log_prob(s)).all()


def test_unknown_distribution_raises():
    with pytest.raises(ValueError, match="unknown distribution"):
        dist.make_distribution("gamma", concentration=1.0, rate=1.0)
