"""The port's scikit-learn ``MLPRegressor`` fit (``eval.fit_mlp_sklearn``)
against scikit-learn, on the CPU.

- (a) In float64, with scikit-learn's own initial weights and epoch orders
  replayed from its ``random_state`` in numpy (``_sklearn_draws``) and
  handed in through the ``init``/``orders`` seam, the fit follows
  ``loss_curve_`` to rtol 1e-10, stops at the same ``n_iter_`` and
  predicts the same to 1e-10 (measured: 1e-15), for one and two outputs
  and a row count with and without a short last batch.
- (b) Members fitted at once, each from its own generator, equal each
  member fitted alone, also where they stop at different epochs.
- (c) ``run_comparison``'s MLP on bridge extrapolation folds against
  ``MLPRegressor(64, 64)`` at ``random_state`` 0 and 1, within bounds set
  from the seed spread measured on these folds.
- (d) ``make_probe_regressor("mlp")`` on zero-padded probe blocks against
  ``MLPRegressor(128, 128)`` on the unpadded blocks, exactly under
  replayed draws, the padded first-layer rows still zero at the end.
"""

import numpy as np
import pytest
import torch

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.eval import baselines as tb
from dpivae_tpu_torch.eval import evaluate as te
from dpivae_tpu_torch.eval.probes import make_probe_regressor
from dpivae_tpu_torch.eval.sklearn_mlp import fit_mlp_sklearn
from dpivae_tpu_torch.train.train import member_generators
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.metrics import regression_metrics
from dpivae_tpu_torch.utils.priors import make_square_dist

sklearn_nn = pytest.importorskip("sklearn.neural_network")
MLPRegressor = sklearn_nn.MLPRegressor

EXACT = 1e-10
# (c): the bridge folds' spread, measured over 6 seeds at n_train 1,024:
# the mean test R² over the 4 folds of one seed reads 0.300 ± 0.216 for
# this fit and 0.273 ± 0.102 for MLPRegressor, so the difference of two
# seeds' means has a standard deviation of 0.17; the bound is 1.5 of it.
# (The batched fixed-epoch fit of --baselines jax reads 0.688 ± 0.033
# there.) Median
# epochs of 8 fits: per-seed medians of MLPRegressor spread over 67-88.
R2_BOUND = 0.25
N_ITER_BOUND = 20


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: under the suite's
    parallel workers the CPU is oversubscribed, and torch's per-op thread
    barriers then cost about a hundred times the work itself."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sklearn_draws(seed, sizes, n_rows, n_epochs, fan_in=None):
    """``MLPRegressor(random_state=seed)``'s initial layers and epoch
    orders, replayed: one RandomState draws each layer's weights, then
    its intercepts (``_init_coef``), then each epoch shuffles the previous
    epoch's order (``shuffle(sample_idx)``). With ``fan_in`` the first
    layer is drawn at that width and zero-padded to ``sizes[0]``."""
    rs = np.random.RandomState(seed)
    init = []
    for layer, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        f = fan_in if layer == 0 and fan_in is not None else d_in
        bound = np.sqrt(6.0 / (f + d_out))
        w = rs.uniform(-bound, bound, (f, d_out))
        b = rs.uniform(-bound, bound, d_out)
        init.append((np.pad(w, ((0, d_in - f), (0, 0))), b))
    idx, orders = np.arange(n_rows), []
    for _ in range(n_epochs):
        perm = np.arange(n_rows)
        rs.shuffle(perm)
        idx = idx[perm]
        orders.append(idx)
    return init, np.stack(orders)


def _stack(inits):
    """Per-member replayed layers stacked on a member axis."""
    return [tuple(torch.as_tensor(np.stack([i[k][j] for i in inits]))
                  for j in range(2)) for k in range(len(inits[0]))]


def _toy(n_rows, n_out, seed, noise=0.1, d=5, n_test=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows + n_test, d))
    y = np.tanh(x @ rng.normal(size=(d, n_out))) + noise * rng.normal(
        size=(n_rows + n_test, n_out))
    return x[:n_rows], y[:n_rows], x[n_rows:], y[n_rows:]


@pytest.mark.parametrize("n_rows", [400, 450])
@pytest.mark.parametrize("n_out", [1, 2])
def test_fit_follows_sklearn_on_its_draws(n_rows, n_out):
    """(a): 400 rows are two full batches of 200, 450 end on a short one."""
    x, y, x_te, _ = _toy(n_rows, n_out, seed=n_rows + n_out)
    max_iter = 1000
    ref = MLPRegressor(hidden_layer_sizes=(16, 16), random_state=3,
                       max_iter=max_iter).fit(x, y[:, 0] if n_out == 1 else y)
    init, orders = _sklearn_draws(3, [5, 16, 16, n_out], n_rows, max_iter)
    fit = fit_mlp_sklearn(torch.as_tensor(x)[None], torch.as_tensor(y)[None],
                          torch.as_tensor(x_te)[None], hidden=(16, 16),
                          max_iter=max_iter, init=_stack([init]),
                          orders=orders[None])
    assert ref.n_iter_ < max_iter
    assert int(fit.n_iter[0]) == ref.n_iter_
    curve = fit.loss_curve[0].numpy()
    np.testing.assert_allclose(curve[:ref.n_iter_], ref.loss_curve_,
                               rtol=EXACT, atol=0)
    assert np.isnan(curve[ref.n_iter_:]).all()
    np.testing.assert_allclose(fit.pred[0].numpy().reshape(-1, n_out),
                               ref.predict(x_te).reshape(-1, n_out),
                               rtol=EXACT, atol=EXACT)
    for (w, b), coef, intercept in zip(fit.layers, ref.coefs_,
                                       ref.intercepts_):
        np.testing.assert_allclose(w[0].numpy(), coef, rtol=EXACT,
                                   atol=EXACT)
        np.testing.assert_allclose(b[0].numpy(), intercept, rtol=EXACT,
                                   atol=EXACT)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_members_fitted_at_once_equal_each_alone(dtype):
    """(b): three members of different noise stop at different epochs
    (the noisiest at max_iter); batched, each equals its fit alone from a
    fresh copy of its generator, in the inputs' dtype."""
    data = [_toy(150, 2, seed=s, noise=noise)
            for s, noise in enumerate((0.02, 0.3, 1.0))]
    x, y, x_te = (torch.as_tensor(np.stack([d[k] for d in data]),
                                  dtype=dtype) for k in range(3))
    kw = dict(hidden=(16, 16), max_iter=400)
    together = fit_mlp_sklearn(x, y, x_te, generators=member_generators(
        5, range(3), "cpu"), **kw)
    assert together.pred.dtype == dtype
    assert len(set(together.n_iter.tolist())) == 3
    assert int(together.n_iter.min()) < kw["max_iter"]
    for m in range(3):
        alone = fit_mlp_sklearn(x[m:m + 1], y[m:m + 1], x_te[m:m + 1],
                                generators=member_generators(5, [m], "cpu"),
                                **kw)
        n = int(alone.n_iter[0])
        assert int(together.n_iter[m]) == n
        torch.testing.assert_close(together.loss_curve[m, :n],
                                   alone.loss_curve[0, :n], rtol=0, atol=0)
        torch.testing.assert_close(together.pred[m], alone.pred[0], rtol=0,
                                   atol=0)


def test_run_comparison_mlp_matches_sklearn_on_bridge_folds(monkeypatch):
    """(c): the four extrapolation folds of one run of the transfer study
    at n_train 1,024 (at 256 and 512 the spread of extrapolation R² swamps
    the gap between the two fits), two seeds each: the mean test R² and
    the median epochs within R2_BOUND and N_ITER_BOUND of
    ``MLPRegressor``'s on the same features."""
    n_iter = []
    fit = tb.fit_mlp_sklearn

    def recorded(*args, **kwargs):
        out = fit(*args, **kwargs)
        n_iter.extend(out.n_iter.tolist())
        return out

    monkeypatch.setattr(tb, "fit_mlp_sklearn", recorded, raising=False)
    case = get_case("bridge")
    dists_test, dists_train = make_square_dist(case)
    g = torch.Generator().manual_seed(0)
    folds = [[sample_response(case, g, n, sample_dist=d[i], device="cpu")
              for n, d in ((1024, dists_train), (128, dists_test))]
             for i in range(4)]
    cfg = TrainConfig().replace(n_train=1024)
    r2, r2_ref, n_iter_ref = [], [], []
    for seed in (0, 1):
        for train, test in folds:
            metrics, _ = te.run_comparison(
                cfg, case, train, test, models=("MLP",), device="cpu",
                generator=torch.Generator().manual_seed(seed))
            r2.append(np.mean(metrics["MLP"]["R2"]))
            one = lambda a: a[None]
            X_tr, X_te = (tb._standardize_features(
                one(train[0]), one(train[1]), one(a[0]), one(a[1]))[0]
                .numpy() for a in (train, test))
            ref = MLPRegressor(hidden_layer_sizes=(64, 64), max_iter=10000,
                               random_state=seed).fit(X_tr, train[2].numpy())
            r2_ref.append(np.mean(regression_metrics(
                test[2].numpy(), ref.predict(X_te).reshape(128, -1))["R2"]))
            n_iter_ref.append(ref.n_iter_)
    gap = abs(np.mean(r2) - np.mean(r2_ref))
    assert gap < R2_BOUND, (np.mean(r2), np.mean(r2_ref))
    assert len(n_iter) == 8
    assert abs(np.median(n_iter) - np.median(n_iter_ref)) <= N_ITER_BOUND, (
        n_iter, n_iter_ref)


def test_mlp_probe_matches_sklearn_on_padded_blocks():
    """(d): three probes of input widths 4, 2 and 3 padded to 4, one
    target each, as ``batched_probe_scores`` packs them; each against
    ``MLPRegressor(hidden_layer_sizes=(128, 128), max_iter=20000,
    random_state=p)`` on its own columns."""
    rng = np.random.default_rng(7)
    widths, n_rows, n_test, max_iter = (4, 2, 3), 200, 100, 2000
    X = rng.normal(size=(3, n_rows + n_test, 4))
    for p, f in enumerate(widths):
        X[p, :, f:] = 0.0
    y = np.sin(X[:, :, 0]) + 0.5 * X[:, :, 1] ** 2 + 0.1 * rng.normal(
        size=X.shape[:2])
    ref_r2, ref_pred, inits, orders = [], [], [], []
    for p, f in enumerate(widths):
        ref = MLPRegressor(hidden_layer_sizes=(128, 128), max_iter=20000,
                           random_state=p).fit(X[p, :n_rows, :f], y[p, :n_rows])
        assert ref.n_iter_ < max_iter
        ref_r2.append(ref.score(X[p, n_rows:, :f], y[p, n_rows:]))
        ref_pred.append(ref.predict(X[p, n_rows:, :f]))
        init, order = _sklearn_draws(p, [4, 128, 128, 1], n_rows, max_iter,
                                     fan_in=f)
        inits.append(init)
        orders.append(order)
    args = (torch.as_tensor(X[:, :n_rows]), torch.as_tensor(y[:, :n_rows]),
            torch.as_tensor(X[:, n_rows:]), torch.as_tensor(y[:, n_rows:]))
    r2 = make_probe_regressor("mlp")(*args, init=_stack(inits),
                                     orders=np.stack(orders))
    np.testing.assert_allclose(r2.numpy(), ref_r2, rtol=0, atol=EXACT)
    fit = fit_mlp_sklearn(args[0], args[1][..., None], args[2],
                          hidden=(128, 128), max_iter=20000,
                          init=_stack(inits), orders=np.stack(orders))
    np.testing.assert_allclose(fit.pred[..., 0].numpy(), np.stack(ref_pred),
                               rtol=EXACT, atol=EXACT)
    w0 = fit.layers[0][0]
    for p, f in enumerate(widths):
        assert torch.count_nonzero(w0[p, f:]) == 0
