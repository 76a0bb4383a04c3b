"""The port's evaluation against the JAX package, on the CPU: the regression
metrics, the LIN/GPR/MLP baselines, the disentanglement probes,
``evaluate_model``, ``run_comparison`` and ``disentanglement_metric``, and
the slot-pruned sample mean behind them.

Inputs are numpy arrays from seeds, the same for both packages; model
weights are JAX-initialized and carried over by ``params_from_jax``, and
the noise JAX's ``sample`` draws is replayed (tests/test_torch_port_model.py).
The MLP fits get JAX's own initial weights and minibatch rows through
their ``init``/``indices`` seam.

Tolerances:

- metrics 1e-6 relative (the same numpy arithmetic);
- LIN predictions atol 1e-5 (f32 least squares on well-conditioned toy
  features, two SVD implementations);
- GPR kernel parameters within 1e-2 in log space and R² within 1e-3: both
  run the same BFGS on the same f32 objective from the same start, and
  stop where f32 can no longer improve it, which moves the optimum by
  about 1e-3 along the flat directions of the likelihood (measured: at
  most 8.5e-4). A member with constant targets has a flat likelihood in
  its length scale, so only its finiteness is held;
- the MLP baseline and probes on JAX's draws: R² within 1e-4, with the
  epoch counts cut (20 for the baseline, 100 for the probes), since
  ReLU networks trained in f32 by two libraries drift apart
  exponentially once a unit sits on its kink (measured: one of three
  baseline members drifts from 1e-4 to 8e-3 in prediction between 25 and
  80 epochs while the others stay within 1e-5);
- against scikit-learn (skipped where it is not installed), the JAX
  package's own standards: GPR R² 0.02, the MLP baseline 0.15, the MLP
  probes 0.08;
- model outputs 1e-4 (as tests/test_torch_port_model.py), probe R² from
  them 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.eval import baselines as jb
from dpivae_tpu.eval import evaluate as je
from dpivae_tpu.eval import probes as jp
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.utils.metrics import regression_metrics as jax_metrics
from dpivae_tpu.utils.priors import factor_indices
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax
from dpivae_tpu_torch.eval import baselines as tb
from dpivae_tpu_torch.eval import evaluate as te
from dpivae_tpu_torch.eval import probes as tp
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.serving import SAMPLE_SLOTS, sample_mean
from dpivae_tpu_torch.train import setup_model
from dpivae_tpu_torch.utils.metrics import regression_metrics
from test_torch_port_model import _replayed_noise

N_TRAIN, N_TEST, N_MC = 64, 24, 8


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _r2(y, p):
    return 1 - ((y - p) ** 2).sum(0) / ((y - y.mean(0)) ** 2).sum(0)


def _toy_members(M=3, N=96, T=48, D=2, Q=2, seed=0, noise=0.05):
    """Member-stacked regression data, as tests/test_baselines.py's."""
    rng = np.random.default_rng(seed)
    X_tr = rng.uniform(-2, 2, (M, N, D)).astype(np.float32)
    X_te = rng.uniform(-2, 2, (M, T, D)).astype(np.float32)

    def f(X, m):
        base = np.sin(X[..., 0] * (1 + 0.2 * m)) + 0.5 * X[..., 1] ** 2
        return np.stack([base + 0.3 * q * X[..., 0] for q in range(Q)], -1)

    Y_tr = np.stack([f(X_tr[m], m) for m in range(M)]).astype(np.float32)
    Y_te = np.stack([f(X_te[m], m) for m in range(M)]).astype(np.float32)
    Y_tr += noise * rng.standard_normal(Y_tr.shape).astype(np.float32)
    return X_tr, Y_tr, X_te, Y_te


def _toy_probes(seed=0, P=3, N=256, D=4, noise=0.3):
    """Probe data, as tests/test_probes.py's."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(P, N, D)).astype(np.float32)
    w = rng.normal(size=(P, D)).astype(np.float32)
    y = np.tanh(np.einsum("pnd,pd->pn", X, w)) + 0.5 * X[..., 0] ** 2
    y = (y + noise * rng.normal(size=y.shape)).astype(np.float32)
    n_tr = N // 2
    return X[:, :n_tr], y[:, :n_tr], X[:, n_tr:], y[:, n_tr:]


def _jax_mlp_draws(key, members, sizes, n_rows, n_epochs, init_fn):
    """The initial layers and minibatch rows the JAX package's batched MLP
    fits draw from ``key`` (baselines.py:253-260, probes.py:167-177)."""
    b = min(200, n_rows)
    n_steps = n_epochs * max(n_rows // b, 1)
    k_init, k_batch = jax.random.split(key)
    layers = jax.vmap(lambda k: init_fn(k, sizes))(
        jax.random.split(k_init, members))
    idx = np.stack([np.asarray(jax.random.randint(k, (b,), 0, n_rows))
                    for k in jax.random.split(k_batch, n_steps)])
    return [(np.asarray(layer["w"]), np.asarray(layer["b"]))
            for layer in layers], idx


def test_regression_metrics_match_jax():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((100, 3))
    p = y + 0.3 * rng.standard_normal((100, 3))
    got, want = regression_metrics(_t(y), p), jax_metrics(y, p)
    assert set(got) == set(want) == {"R2", "MSE", "MAE"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)


def test_lin_matches_jax():
    X_tr, Y_tr, X_te, _ = _toy_members()
    want = np.asarray(jb.fit_lin_batched(X_tr, Y_tr, X_te))
    got = tb.fit_lin_batched(_t(X_tr), _t(Y_tr), _t(X_te)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("members", [
    dict(), dict(noise=0.0, N=128), dict(seed=5, M=4, N=200, D=5, Q=3)],
    ids=["noisy", "noiseless", "wide"])
def test_gpr_matches_jax(members):
    X_tr, Y_tr, X_te, Y_te = _toy_members(**members)
    want, want_k = (np.asarray(a) for a in jb.fit_gpr_batched(X_tr, Y_tr,
                                                              X_te))
    got, got_k = (a.numpy() for a in tb.fit_gpr_batched(
        _t(X_tr), _t(Y_tr), _t(X_te)))
    assert np.isfinite(got).all() and got_k.shape == (len(X_tr), 2)
    np.testing.assert_allclose(np.log(got_k), np.log(want_k), rtol=0,
                               atol=1e-2)
    for m in range(len(X_tr)):
        np.testing.assert_allclose(_r2(Y_te[m], got[m]), _r2(Y_te[m], want[m]),
                                   rtol=0, atol=1e-3)


def test_gpr_flat_targets_stay_finite():
    X_tr, Y_tr, X_te, _ = _toy_members(M=2, N=48, T=16)
    Y_tr[1] = 1.0
    pred, kparams = tb.fit_gpr_batched(_t(X_tr), _t(Y_tr), _t(X_te))
    assert torch.isfinite(pred).all() and torch.isfinite(kparams).all()
    # The other member is untouched by its neighbour's degeneracy
    want, _ = jb.fit_gpr_batched(X_tr[:1], Y_tr[:1], X_te[:1])
    np.testing.assert_allclose(pred[0].numpy(), np.asarray(want)[0],
                               atol=1e-3)


def test_gpr_failed_factorisation_falls_back_to_the_start():
    """A NaN feature makes every factorisation fail: the objective is NaN,
    BFGS ends at once, and the kernel parameters stay at (1, 1)."""
    X_tr, Y_tr, X_te, _ = _toy_members(M=2, N=32, T=8)
    X_tr[0, 3, 0] = np.nan
    _, kparams = tb.fit_gpr_batched(_t(X_tr), _t(Y_tr), _t(X_te))
    np.testing.assert_array_equal(kparams[0].numpy(), [1.0, 1.0])
    assert (kparams[1] != 1.0).all()


def test_gpr_matches_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF, WhiteKernel

    X_tr, Y_tr, X_te, Y_te = _toy_members()
    pred, _ = tb.fit_gpr_batched(_t(X_tr), _t(Y_tr), _t(X_te))
    for m in range(len(X_tr)):
        ref = GaussianProcessRegressor(RBF() + WhiteKernel()).fit(
            X_tr[m], Y_tr[m]).predict(X_te[m])
        np.testing.assert_allclose(_r2(Y_te[m], pred[m].numpy()),
                                   _r2(Y_te[m], ref), rtol=0, atol=0.02)


def test_mlp_baseline_matches_jax_on_jax_draws():
    X_tr, Y_tr, X_te, Y_te = _toy_members(N=128)
    key, n_epochs = jax.random.PRNGKey(0), 20
    want = np.asarray(jb.fit_mlp_baseline_batched(
        X_tr, Y_tr, X_te, n_epochs=n_epochs, key=key))
    init, idx = _jax_mlp_draws(key, len(X_tr), [2, 64, 64, 2], 128, n_epochs,
                               jb._mlp_init)
    got = tb.fit_mlp_baseline_batched(_t(X_tr), _t(Y_tr), _t(X_te),
                                      n_epochs=n_epochs, init=init,
                                      indices=idx).numpy()
    for m in range(len(X_tr)):
        np.testing.assert_allclose(_r2(Y_te[m], got[m]), _r2(Y_te[m], want[m]),
                                   rtol=0, atol=1e-4)


def test_mlp_baseline_agrees_with_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.neural_network import MLPRegressor

    X_tr, Y_tr, X_te, Y_te = _toy_members(N=128)
    pred = tb.fit_mlp_baseline_batched(
        _t(X_tr), _t(Y_tr), _t(X_te), n_epochs=400,
        generator=torch.Generator().manual_seed(0)).numpy()
    for m in range(len(X_tr)):
        ref = MLPRegressor(hidden_layer_sizes=(64, 64), max_iter=10000).fit(
            X_tr[m], Y_tr[m]).predict(X_te[m])
        r2 = _r2(Y_te[m], pred[m])
        assert r2.min() > 0.5
        np.testing.assert_allclose(r2, _r2(Y_te[m], ref), rtol=0, atol=0.15)


def test_mlp_probes_match_jax_on_jax_draws():
    Xtr, ytr, Xte, yte = _toy_probes()
    key, n_epochs = jax.random.PRNGKey(0), 100
    fan_in = np.array([4, 2, 3], np.float32)
    want = np.asarray(jp.fit_mlp_probes_batched(
        Xtr, ytr, Xte, yte, hidden=(32, 32), n_epochs=n_epochs, key=key,
        fan_in=fan_in))
    init, idx = _jax_mlp_draws(key, 3, [4, 32, 32, 1], 128, n_epochs,
                               jp._mlp_probe_init)
    got = tp.fit_mlp_probes_batched(
        _t(Xtr), _t(ytr), _t(Xte), _t(yte), hidden=(32, 32),
        n_epochs=n_epochs, fan_in=fan_in, init=init, indices=idx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mlp_probes_close_to_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.neural_network import MLPRegressor

    Xtr, ytr, Xte, yte = _toy_probes()
    r2 = tp.fit_mlp_probes_batched(
        _t(Xtr), _t(ytr), _t(Xte), _t(yte), hidden=(32, 32), n_epochs=400,
        generator=torch.Generator().manual_seed(0)).numpy()
    for p in range(len(Xtr)):
        ref = MLPRegressor(hidden_layer_sizes=(32, 32), max_iter=2000,
                           random_state=0).fit(Xtr[p], ytr[p]).score(
                               Xte[p], yte[p])
        assert abs(r2[p] - ref) < 0.08, (p, r2[p], ref)
        assert r2[p] > 0.5


def test_linear_probes_match_jax_with_padding():
    Xtr, ytr, Xte, yte = _toy_probes(P=6)
    pad = ((0, 0), (0, 0), (0, 2))
    Xtr_p, Xte_p = np.pad(Xtr, pad), np.pad(Xte, pad)
    want = np.asarray(jp.fit_linear_probes_batched(Xtr_p, ytr, Xte_p, yte))
    got = tp.fit_linear_probes_batched(_t(Xtr_p), _t(ytr), _t(Xte_p),
                                       _t(yte)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _latents(seed, M=2, N=64, F=3):
    rng = np.random.default_rng(seed)
    lat = {b: rng.normal(size=(M, N, d)).astype(np.float32)
           for b, d in (("zx", 2), ("zc", 4), ("zy", 1))}
    z = rng.normal(size=(M, N, F)).astype(np.float32)
    z[..., 0] = lat["zx"][..., 0] + 0.5 * lat["zx"][..., 1]
    return lat, z


def test_pack_and_linear_probe_scores_match_jax():
    (lat_tr, z_tr), (lat_te, z_te) = _latents(1), _latents(2)
    want = jp.pack_probe_batch(lat_tr, lat_te, z_tr, z_te, 3)
    got = tp.pack_probe_batch(lat_tr, lat_te, z_tr, z_te, 3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    scores = tp.batched_probe_scores(lat_tr, lat_te, z_tr, z_te, 3,
                                     regressor="linear", device="cpu")
    ref = jp.batched_probe_scores(lat_tr, lat_te, z_tr, z_te, 3,
                                  regressor="linear_jax")
    assert scores.shape == (2, 3, 3)
    np.testing.assert_allclose(scores, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Unknown regressor"):
        tp.batched_probe_scores(lat_tr, lat_te, z_tr, z_te, 3,
                                regressor="gpr", device="cpu")


# ---------------------------------------------------------------------------
# The model-level paths on simple_beam/"dpivae"


def _data(n, seed):
    """(x, c, y, z) for simple_beam from numpy: factors uniform in their
    ground-truth ranges, x through the JAX package's frozen surrogate."""
    case = jax_get_case("simple_beam")
    rng = np.random.default_rng(seed)
    z = np.stack([rng.uniform(f.args["low"], f.args["high"], n)
                  for f in case.factors], -1).astype(np.float32)
    noise = lambda d: 0.02 * rng.standard_normal((n, d)).astype(np.float32)
    x = np.asarray(case.full_model(jnp.asarray(z))) + noise(case.nd_x)
    c = z[:, factor_indices(case.factors, "c")] + noise(case.nd_c)
    y = z[:, factor_indices(case.factors, "y")] + noise(case.nd_y)
    return x.astype(np.float32), c, y, z


def _models(**over):
    over = dict(n_train=N_TRAIN, n_batch=16, n_test=N_TEST, n_mc_test=N_MC,
                use_seed=True, name="beam-s", **over)
    data = _data(N_TRAIN, 0)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    model = setup_model(cfg, case, data, device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return data, (jcfg, jcase, jmodel, jparams), (cfg, case, model, params)


@pytest.mark.parametrize("cond", [False, True])
def test_evaluate_model_matches_jax(cond):
    _, (jcfg, jcase, jmodel, jparams), (cfg, case, model, params) = _models()
    data_test = _data(N_TEST, 1)
    key = jax.random.PRNGKey(3)
    want_m, want_p = je.evaluate_model(jcfg, jcase, jmodel, jparams,
                                       data_test, cond=cond, key=key)
    got_m, got_p = te.evaluate_model(
        cfg, case, model, params, data_test, cond=cond,
        noise=_replayed_noise(key, jmodel, N_MC, N_TEST, cond))
    assert set(got_m) == set(want_m) == {"beam-s"}
    assert got_p["beam-s"].shape == (N_TEST, 1)
    np.testing.assert_allclose(got_p["beam-s"], want_p["beam-s"], rtol=1e-4,
                               atol=1e-4)
    for name in ("R2", "MSE", "MAE"):
        np.testing.assert_allclose(got_m["beam-s"][name],
                                   want_m["beam-s"][name], rtol=1e-3,
                                   atol=1e-4)


def test_run_comparison_matches_jax(monkeypatch):
    """LIN through ``run_comparison``'s features against the JAX package's
    batched fit (tight) and its scikit-learn run_comparison (its own
    standard, 0.02 in R²); the GPR, fitted as scikit-learn fits it
    (float64, L-BFGS-B), against that scikit-learn run_comparison (1e-6
    in R²; on these 33 features L-BFGS-B leaves the length scale at its
    upper bound); the MLP, fitted by MLPRegressor's rules, against
    ``MLPRegressor(64, 64)`` at random_state 0 and 1 on the same features:
    test R² within 1.1 and epochs within 100 of their mean. The bounds are
    twice the spread measured over 10 seeds on these 64 points, where the
    MLP overfits: R² -0.39 ± 0.42 (port) and -0.52 ± 0.49 (scikit-learn),
    epochs 464 ± 41 and 470 ± 20."""
    _, (jcfg, jcase, _, _), (cfg, case, _, _) = _models()
    data_train, data_test = _data(N_TRAIN, 0), _data(N_TEST * 2, 1)
    n_iter = []
    fit_mlp = tb.fit_mlp_sklearn

    def recorded(*args, **kwargs):
        out = fit_mlp(*args, **kwargs)
        n_iter.extend(out.n_iter.tolist())
        return out

    monkeypatch.setattr(tb, "fit_mlp_sklearn", recorded, raising=False)
    got_m, got_p = te.run_comparison(cfg, case, data_train, data_test,
                                     generator=torch.Generator(),
                                     device="cpu")
    assert set(got_m) == set(got_p) == {"LIN", "GPR", "MLP"}
    batched, _ = jb.run_comparison_batched(
        tuple(a[None] for a in data_train), tuple(a[None] for a in data_test),
        models=("LIN",))
    np.testing.assert_allclose(got_m["LIN"]["R2"], batched[0]["LIN"]["R2"],
                               rtol=0, atol=1e-5)
    for name in ("R2", "MSE", "MAE"):
        assert np.isfinite(got_m["MLP"][name]).all()
    pytest.importorskip("sklearn")
    from sklearn.neural_network import MLPRegressor

    one = lambda a: torch.as_tensor(a)[None]
    X_tr, X_te = (tb._standardize_features(
        one(data_train[0]), one(data_train[1]), one(a[0]), one(a[1]))[0]
        .numpy() for a in (data_train, data_test))
    mlps = [MLPRegressor(hidden_layer_sizes=(64, 64), max_iter=10000,
                         random_state=s).fit(X_tr, data_train[2][:, 0])
            for s in (0, 1)]
    ref_r2 = np.mean([m.score(X_te, data_test[2][:, 0]) for m in mlps])
    assert abs(float(got_m["MLP"]["R2"][0]) - ref_r2) < 1.1
    assert len(n_iter) == 1
    assert abs(n_iter[0] - np.mean([m.n_iter_ for m in mlps])) < 100
    ref, ref_p = je.run_comparison(jcfg, jcase, data_train, data_test)
    np.testing.assert_allclose(got_m["LIN"]["R2"], ref["LIN"]["R2"], rtol=0,
                               atol=0.02)
    np.testing.assert_allclose(got_m["GPR"]["R2"], ref["GPR"]["R2"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_p["GPR"], ref_p["GPR"], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="n_train"):
        te.run_comparison(cfg.replace(n_train=N_TRAIN + 1), case, data_train,
                          data_test, device="cpu")


def test_disentanglement_metric_rows_match_jax():
    """Linear probes on one posterior sample per point, train then test
    split (JAX splits its key in two, evaluate.py:201), replayed."""
    _, (jcfg, jcase, jmodel, jparams), (cfg, case, model, params) = _models()
    data_train, data_test = _data(N_TRAIN, 0), _data(N_TEST * 2, 1)
    key = jax.random.PRNGKey(4)
    want = je.disentanglement_metric(jcfg, jmodel, jparams, jcase, data_train,
                                     data_test, regressor="linear", key=key)
    k1, k2 = jax.random.split(key)
    noise = (_replayed_noise(k1, jmodel, 1, N_TRAIN, False),
             _replayed_noise(k2, jmodel, 1, N_TEST * 2, False))
    got = te.disentanglement_metric(cfg, model, params, case, data_train,
                                    data_test, regressor="linear", noise=noise)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-3)


def test_disentanglement_metric_mlp_rows():
    _, _, (cfg, case, model, params) = _models()
    data_train, data_test = _data(N_TRAIN, 0), _data(N_TEST, 1)
    rows = te.disentanglement_metric(
        cfg, model, params, case, data_train, data_test, regressor="mlp",
        generator=torch.Generator().manual_seed(0),
        mlp_kwargs=dict(max_iter=3))
    assert [r[:2] for r in rows] == [[b, f.name] for f in case.factors
                                     for b in ("zx", "zc", "zy")]
    assert all(np.isfinite(r[2]) for r in rows)
    with pytest.raises(ValueError, match="Unknown regressor"):
        te.disentanglement_metric(cfg, model, params, case, data_train,
                                  data_test, regressor="gpr")


@pytest.mark.parametrize("outputs", [
    ("y",), ("zx", "zc", "zy"), ("xh_p",), ("xh_d", "c_sample"),
    tuple(SAMPLE_SLOTS)], ids=["y", "latents", "xh_p", "xh_d-c", "all"])
def test_sample_mean_slots_equal_the_full_sample(outputs, monkeypatch):
    """Each requested mean equals the full ``sample``'s bit for bit under
    the same generator, the generator ends where the full sample leaves
    it, and only what the outputs need runs: "y" and the latents no
    decoder_x (on the CPU the kernel's wrapper runs its plain version,
    counted here)."""
    _, _, (cfg, case, model, params) = _models(use_pallas=True)
    model = dataclasses.replace(model, mc_chunk=None)
    x, c = (_t(a) for a in _data(N_TEST, 2)[:2])
    calls = []
    plain = ops.fused_mlp_reference
    monkeypatch.setattr(ops, "fused_mlp_reference",
                        lambda *a: calls.append(1) or plain(*a))

    def run(fn):
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            out = fn(g)
        return out, torch.rand(4, generator=g)

    full, after_full = run(lambda g: model.sample(
        params, x, c, n=N_MC, grl_alpha=cfg.lambda_g0, generator=g))
    calls.clear()
    means, after = run(lambda g: sample_mean(
        model, params, x, c, outputs=outputs, n=N_MC,
        grl_alpha=cfg.lambda_g0, generator=g))
    for name, m in zip(outputs, means):
        assert torch.equal(m, torch.mean(full[SAMPLE_SLOTS[name]], dim=0)), name
    assert torch.equal(after, after_full)
    needs_branch = bool({"x_sample", "xh_d"} & set(outputs))
    assert len(calls) == int(needs_branch)
