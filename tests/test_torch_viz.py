"""The figures' data against the JAX package, on the CPU: the traversal
bounds and grids of the three cases, ``pred_decomposition`` (the data of
the prediction figures), the posterior latent frames of the corner and
marginal figures, ``DPIVAE.sample_prior`` and the prior frames, for
simple_beam/"dpivae" (S model) and bridge/"DPIVAE-A" (P model, with
``cond``); the study figure's per-λ statistics against pandas; and the
annealing figure's arrays against JAX's schedules.

Both packages get the same weights (JAX-initialized, carried over by
``params_from_jax``) and JAX's own traversal data
(``dpivae_tpu.viz.visualization._traversal_data``), and the port gets the
standard normals JAX draws from each traversal point's key (the key
structure of the JAX figure functions, replayed as in
tests/test_torch_port_pmodel.py).

Tolerances: whole-model outputs rtol/atol 1e-4, as in
tests/test_torch_port_model.py (f32 on both sides, sums in other orders);
the traversal bounds rtol 1e-6 (one f32 icdf on each side); the schedules
rtol/atol 1e-6 (the port's cyclical ramp runs in float64, JAX's in f32);
the per-λ statistics rtol 1e-12 (float64 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.utils import annealing as jax_annealing
from dpivae_tpu.viz import visualization as jviz
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.scripts.disentanglement_metric import lambda_stats
from dpivae_tpu_torch.scripts.plot_annealing import schedule_arrays
from dpivae_tpu_torch.viz import visualization as viz
from test_torch_port_pmodel import _models, _replayed_noise

RTOL = ATOL = 1e-4
N_PLOT, N_INTERP = 50, 3
CONFIGS = [("simple_beam", "dpivae", False), ("bridge", "DPIVAE-A", True)]
_ids = [f"{c}-{p}" for c, p, _ in CONFIGS]


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module", params=CONFIGS, ids=_ids)
def setup(request):
    case_name, preset, cond = request.param
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(case_name, preset)
    return (jcfg, jmodel, jparams, jax_get_case(case_name)), (
        cfg, model, params, get_case(case_name)), cond


def _jax_points(jax_side, idx, k_data, point_keys, cond):
    """JAX's traversal data of factor ``idx`` from ``k_data``, its
    ``_sample`` outputs at each point, and the normals each point's key
    draws, for the port."""
    jcfg, jmodel, jparams, jcase = jax_side
    x, c, y, sweep = jviz._traversal_data(jcase, idx, N_INTERP, N_PLOT,
                                          k_data)
    outs = [jviz._sample(jmodel, jparams, jcfg, k, x[:, i], c[:, i], cond)
            for i, k in enumerate(point_keys)]
    noise = [_replayed_noise(k, jmodel, 1, N_PLOT, cond) for k in point_keys]
    return (x, c, y), sweep, outs, noise


@pytest.mark.parametrize("case_name", ["simple_beam", "damped_oscillator",
                                       "bridge"])
def test_traversal_bounds_and_grid_match_jax(case_name):
    jcase, case = jax_get_case(case_name), get_case(case_name)
    if case_name == "bridge":
        assert "f" in {f.type for f in case.factors}
    for got, want in zip(viz.traversal_bounds(case),
                         jviz._traversal_bounds(jcase)):
        _close(got, want, rtol=1e-6, atol=0)
    for idx in range(len(case.factors)):
        for got, want in zip(viz.traversal_grid(case, idx, 5),
                             jviz._traversal_grid(jcase, idx, 5)):
            _close(got, want, rtol=1e-6, atol=0, msg=f"factor {idx}")


def test_traversal_data_shapes_on_cpu():
    case = get_case("bridge")
    x, c, y, sweep = viz.traversal_data(
        case, 1, N_INTERP, N_PLOT, torch.Generator().manual_seed(0),
        device="cpu")
    assert x.shape == (N_PLOT, N_INTERP, case.nd_x)
    assert c.shape == (N_PLOT, N_INTERP, case.nd_c)
    assert y.shape == (N_PLOT, N_INTERP, case.nd_y)
    np.testing.assert_array_equal(sweep, viz.traversal_grid(case, 1,
                                                            N_INTERP)[1])


def test_pred_decomposition_matches_jax(setup):
    jax_side, (cfg, model, params, case), cond = setup
    key = jax.random.PRNGKey(3)
    for idx in range(len(case.factors)):
        k_factor = jax.random.fold_in(key, idx)
        want, want_sweep = jviz._pred_decomposition(
            jax_side[1], jax_side[2], jax_side[0], jax_side[3], idx,
            N_INTERP, N_PLOT, cond, k_factor)
        k_data, k_samp = jax.random.split(k_factor)
        data, _, _, noise = _jax_points(
            jax_side, idx, k_data,
            [jax.random.fold_in(k_samp, i) for i in range(N_INTERP)], cond)
        got, sweep = viz.pred_decomposition(
            model, params, cfg, case, idx, N_INTERP, N_PLOT, cond,
            data=data, noise=noise, device="cpu")
        np.testing.assert_array_equal(sweep, want_sweep)
        assert set(got) == set(viz.PRED_STATS) == set(want[0])
        for name in viz.PRED_STATS:
            assert got[name].shape == (N_INTERP, case.nd_x)
            _close(got[name], np.stack([r[name] for r in want]),
                   msg=f"factor {idx} {name}")


def test_latent_frames_match_jax(setup):
    """The posterior frames of interp_corner_latent_space (split keys) and
    of plot_marginal_post (fold_in keys, offset 2000): JAX's ``_sample``
    outputs 5-7 at each traversal point."""
    jax_side, (cfg, model, params, case), cond = setup
    key = jax.random.PRNGKey(4)
    idx = 1
    k_data, k_samp = jax.random.split(key)
    corner = (k_data, [jax.random.fold_in(k_samp, i) for i in range(N_INTERP)])
    k_factor = jax.random.fold_in(key, idx)
    post = (k_factor, [jax.random.fold_in(k_factor, 2000 + i)
                       for i in range(N_INTERP)])
    for fn, (k_d, keys) in ((viz.corner_data, corner),
                            (viz.marginal_post_data, post)):
        data, want_sweep, outs, noise = _jax_points(jax_side, idx, k_d, keys,
                                                    cond)
        latents, sweep = fn(model, params, cfg, case, idx, N_INTERP, N_PLOT,
                            cond, data=data, noise=noise, device="cpu")
        np.testing.assert_array_equal(sweep, want_sweep)
        for slot, got in zip((5, 6, 7), latents):
            _close(got, np.stack([o[slot][0] for o in outs]),
                   msg=f"{fn.__name__} slot {slot}")


def test_sample_prior_matches_jax(setup):
    (jcfg, jmodel, jparams, jcase), (cfg, model, params, case), _ = setup
    key = jax.random.PRNGKey(5)
    idx, n = 0, 2
    x, c, y, _ = jviz._traversal_data(jcase, idx, N_INTERP, N_PLOT, key)
    c, y = c[:, 0], y[:, 0]
    want = jmodel.sample_prior(jparams, key, jnp.asarray(c), jnp.asarray(y),
                               n=n)
    k_c, k_y = jax.random.split(key)
    noise = {name: torch.from_numpy(np.array(jax.random.normal(
        k, (n, N_PLOT, width))))
        for name, k, width in (("z_c", k_c, cfg.nz_c), ("z_y", k_y, cfg.nz_y))}
    with torch.no_grad():
        got = model.sample_prior(params, c, y, n=n, noise=noise, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    # The prior frames of plot_marginal_prior: fold_in(key, idx) draws the
    # data, its fold_in(1000 + i) point i.
    k_factor = jax.random.fold_in(key, idx)
    _, c, y, _ = jviz._traversal_data(jcase, idx, N_INTERP, N_PLOT, k_factor)
    keys = [jax.random.fold_in(k_factor, 1000 + i) for i in range(N_INTERP)]
    want = [jmodel.sample_prior(jparams, k, jnp.asarray(c[:, i]),
                                jnp.asarray(y[:, i]), n=1)
            for i, k in enumerate(keys)]
    noise = []
    for k in keys:
        k_c, k_y = jax.random.split(k)
        noise.append({name: torch.from_numpy(np.array(jax.random.normal(
            kk, (1, N_PLOT, width))))
            for name, kk, width in (("z_c", k_c, cfg.nz_c),
                                    ("z_y", k_y, cfg.nz_y))})
    (zc, zy), _ = viz.marginal_prior_data(
        model, params, cfg, case, idx, N_INTERP, N_PLOT,
        data=(np.zeros((N_PLOT, N_INTERP, case.nd_x), np.float32), c, y),
        noise=noise, device="cpu")
    _close(zc, np.stack([np.asarray(w[0][0]) for w in want]))
    _close(zy, np.stack([np.asarray(w[2][0]) for w in want]))


def test_sample_prior_draws_from_its_generator():
    _, (cfg, model, params) = _models("simple_beam", "dpivae")
    c, y = np.ones((7, 1), np.float32), np.ones((7, 1), np.float32)
    draw = lambda: model.sample_prior(
        params, c, y, n=3, generator=torch.Generator().manual_seed(1),
        device="cpu")
    with torch.no_grad():
        first, again = draw(), draw()
    assert first[0].shape == (3, 7, cfg.nz_c)
    assert first[2].shape == (3, 7, cfg.nz_y)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        model.sample_prior(params, c, y, device="cpu")


def test_ground_truth_posterior_data_matches_jax():
    """The posterior z_x of plot_ground_truth_posterior on JAX's data and
    normals (split(key, 3): data, samples, prior draws)."""
    (jcfg, jmodel, jparams), (cfg, model, params) = _models("simple_beam",
                                                            "dpivae")
    jcase, case = jax_get_case("simple_beam"), get_case("simple_beam")
    k_data, k_samp, k_prior = jax.random.split(jax.random.PRNGKey(6), 3)
    from dpivae_tpu.utils.data import sample_response as jax_sample_response
    x, c, _, z = (np.asarray(a) for a in jax_sample_response(
        jcase, k_data, N_PLOT, sample_dist=jcase.gt_dist()))
    prior = np.asarray(jcase.prior_x_dist().sample(k_prior, (N_PLOT,)))
    out = jviz._sample(jmodel, jparams, jcfg, k_samp, x, c, False)
    z_gt, zx_post, got_prior = viz.ground_truth_posterior_data(
        model, params, cfg, case, case.gt_dist(), N_PLOT, data=(x, c, z),
        noise=_replayed_noise(k_samp, jmodel, 1, N_PLOT, False),
        prior_samples=prior, device="cpu")
    np.testing.assert_array_equal(z_gt.numpy(), z[:, list(jcase.z_idx_x)])
    np.testing.assert_array_equal(got_prior.numpy(), prior)
    _close(zx_post, out[5][0])


def test_lambda_stats_equal_pandas_groupby():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    lambdas = np.array([1.0, -10.0, 0.0, 1.0, 100.0, -10.0, 1.0, 0.0])
    scores = rng.uniform(0.0, 1.0, lambdas.size)
    # λ 100 and 1000 have a single run each: their std is NaN, as pandas
    # gives.
    lambdas = np.append(lambdas, 1e3)
    scores = np.append(scores, 0.25)
    keys, mean, std = lambda_stats(lambdas, scores)
    grp = pd.DataFrame({"lambda": lambdas, "score": scores}).groupby("lambda")
    want_mean, want_std = grp.mean()["score"], grp.std()["score"]
    np.testing.assert_array_equal(keys, want_mean.index.values)
    np.testing.assert_allclose(mean, want_mean.values, rtol=1e-12)
    np.testing.assert_allclose(std, want_std.values, rtol=1e-12)
    single = np.isin(keys, (100.0, 1e3))
    assert np.isnan(std[single]).all() and np.isfinite(std[~single]).all()


def test_annealing_arrays_match_jax():
    n_iter, mu, cov, n_cycles, R = 300, 0.1, 0.15, 5, 0.5
    t, cyc, sig = schedule_arrays(n_iter, mu, cov, n_cycles, R)
    np.testing.assert_array_equal(t, np.arange(n_iter))
    steps = jnp.arange(n_iter)
    want_cyc = jax.vmap(jax_annealing.cyclical_schedule(n_iter, n_cycles,
                                                        R))(steps)
    want_sig = jax.vmap(jax_annealing.sigmoid_schedule(n_iter, mu, cov))(steps)
    _close(cyc, want_cyc, rtol=1e-6, atol=1e-6)
    _close(sig, want_sig, rtol=1e-6, atol=1e-6)
