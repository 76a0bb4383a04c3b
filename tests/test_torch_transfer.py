"""The transfer study of the port on the CPU: the box distributions,
``make_distribution``'s mixtures and ``make_square_dist`` against the JAX
package's, a bridge "DPIVAE-A" (P model) member of ``train_sweep_data``
against its single run, the default baselines' GPR against scikit-learn
on bridge folds, the CSV and LaTeX writer against pandas' own
``to_csv``/``to_latex`` of the JAX script's aggregation, and the study
program end to end at a tiny size
(1 run x 4 domains, 30 steps, n_train 64) with both baseline choices and
a resumed rerun.

Tolerances: densities rtol 1e-6 (f32 on both sides); a member against its
single run rtol/atol 1e-4 after 20 Adam steps (batched and single matrix
products sum in other orders, as tests/test_torch_sweep_io.py holds
damped_oscillator's members).
"""

import csv
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.utils import distributions as jd
from dpivae_tpu.utils.priors import make_square_dist as jax_make_square_dist
from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.scripts import regression_comparison as transfer
from dpivae_tpu_torch.sweep import train_sweep_data
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train import train as train_mod
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import member_generators
from dpivae_tpu_torch.utils import distributions as td
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.priors import make_square_dist

TOL = 1e-4
TINY = ["--n_runs", "1", "--n_iter", "30", "--n_train", "64", "--n_val",
        "32", "--n_test", "32", "--device", "cpu"]



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: under the suite's
    parallel workers the CPU is oversubscribed, and torch's per-op thread
    barriers then cost about a hundred times the work itself."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _lp(dist, z):
    return dist.log_prob(torch.from_numpy(np.asarray(z, np.float32))).numpy()


def test_make_square_dist_matches_jax():
    """Every fold's lows and highs exactly, in the same order: fold i
    trains on quadrants {i, i-1, i-2} and tests on i-3 (mod 4)."""
    want_train, want_test = jax_make_square_dist(jax_get_case("bridge"))
    got_train, got_test = make_square_dist(get_case("bridge"))
    assert len(got_train) == len(got_test) == 4
    for g, w in zip(got_train, want_train):
        assert isinstance(g, td.UniformBoxMixture)
        np.testing.assert_array_equal(g.lows, np.asarray(w.lows))
        np.testing.assert_array_equal(g.highs, np.asarray(w.highs))
    for g, w in zip(got_test, want_test):
        assert isinstance(g, td.BoxUniform)
        np.testing.assert_array_equal(g.low, np.asarray(w.low))
        np.testing.assert_array_equal(g.high, np.asarray(w.high))
    # The held-out quadrant is the one quadrant its fold does not train on
    for g_tr, g_te in zip(got_train, got_test):
        assert not any(np.array_equal(g_te.low, lo) for lo in g_tr.lows)
    with pytest.raises(AssertionError, match="2 physics latents"):
        make_square_dist(get_case("damped_oscillator"))


def _dists():
    """(port, JAX) pairs of each box distribution and a weighted mixture
    of boxes, over 3 dims."""
    lows = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, -1.0], [1.0, 2.0, -1.0]],
                    np.float32)
    highs = np.array([[1.0, 2.0, 1.0], [3.0, 2.0, 1.0], [3.0, 5.0, 1.0]],
                     np.float32)
    box = (td.BoxUniform(lows[0], highs[0]), jd.BoxUniform(lows[0], highs[0]))
    mix = (td.UniformBoxMixture(lows, highs), jd.UniformBoxMixture(lows, highs))
    weights = (1.0, 3.0, 0.5)
    msf = (td.MixtureSameFamily(weights, tuple(
               td.BoxUniform(lo, hi) for lo, hi in zip(lows, highs))),
           jd.MixtureSameFamily(weights, tuple(
               jd.BoxUniform(lo, hi) for lo, hi in zip(lows, highs))))
    return {"box": box, "mixture": mix, "weighted": msf}, lows, highs


@pytest.mark.parametrize("name", ["box", "mixture", "weighted"])
def test_box_log_prob_matches_jax(name):
    """log_prob on the same numpy points, inside (also on a face) and
    outside the support."""
    dists, lows, highs = _dists()
    got_dist, want_dist = dists[name]
    rng = np.random.default_rng(0)
    z = rng.uniform(-1.5, 5.5, (200, 3)).astype(np.float32)
    z[:3] = lows  # on the lower faces
    z[3:6] = highs  # on the upper faces
    got, want = _lp(got_dist, z), np.asarray(want_dist.log_prob(jnp.asarray(z)))
    assert got.shape == want.shape == (200,)
    assert np.isneginf(got).any() and np.isfinite(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    inside = np.isfinite(want)
    np.testing.assert_allclose(got[inside], want[inside], rtol=1e-6)


@pytest.mark.parametrize("name", ["box", "mixture", "weighted"])
def test_box_samples_stay_inside_with_the_weights(name):
    """Samples lie in the support; each component's share of a seeded
    draw lies within 3 sigma of its weight."""
    dists, lows, highs = _dists()
    dist = dists[name][0]
    n = 6000
    s = dist.sample(torch.Generator().manual_seed(1), (n,)).numpy()
    assert s.shape == (n, 3)
    assert np.isfinite(_lp(dist, s)).all()
    if name == "box":
        return
    # The boxes meet only on faces: x below 1 is component 0, y above 2
    # component 2, the rest component 1.
    comp = np.where(s[:, 0] < 1.0, 0, np.where(s[:, 1] > 2.0, 2, 1))
    share = np.bincount(comp, minlength=3) / n
    w = np.array([1.0, 1.0, 1.0] if name == "mixture" else [1.0, 3.0, 0.5])
    w = w / w.sum()
    sigma = np.sqrt(w * (1 - w) / n)
    assert (np.abs(share - w) < 3 * sigma).all(), (share, w)


def test_make_distribution_builds_a_mixture_as_jax():
    """A case factor may name a weighted mixture of component specs: its
    log_prob equals the JAX package's on the same points, and a seeded
    draw puts the uniform component's weight in its box (within 3
    sigma)."""
    spec = dict(weights=[0.3, 0.7], components=[
        {"dist": "normal", "args": {"loc": 0.0, "scale": 1.0}},
        {"dist": "uniform", "args": {"low": 2.0, "high": 3.0}}])
    got = td.make_distribution("mixture", **spec)
    want = jd.make_distribution(
        "mixture", weights=list(spec["weights"]),
        components=[dict(c) for c in spec["components"]])
    assert isinstance(got, td.MixtureSameFamily)
    assert len(spec["components"]) == 2  # the spec is not consumed
    z = np.linspace(-3.0, 4.0, 57).astype(np.float32)
    np.testing.assert_allclose(_lp(got, z),
                               np.asarray(want.log_prob(jnp.asarray(z))),
                               rtol=1e-6)
    s = got.sample(torch.Generator().manual_seed(0), (4000,)).numpy()
    share = np.mean((s >= 2.0) & (s <= 3.0))
    assert abs(share - 0.7) < 3 * np.sqrt(0.7 * 0.3 / 4000)


def test_mixture_refuses_bad_weights():
    comps = (td.Normal(0.0, 1.0), td.Normal(1.0, 1.0))
    with pytest.raises(ValueError, match="non-negative"):
        td.MixtureSameFamily(weights=(0.5, -0.5), components=comps)
    with pytest.raises(ValueError, match="positive sum"):
        td.MixtureSameFamily(weights=(0.0, 0.0), components=comps)
    with pytest.raises(ValueError, match="length"):
        td.MixtureSameFamily(weights=(1.0,), components=comps)


def test_p_model_data_sweep_member_equals_single_run():
    """A bridge "DPIVAE-A" member of ``train_sweep_data`` on quadrant
    datasets equals ``train_model`` given its data, its init from its
    generator and the same generator (as tests/test_torch_sweep_io.py
    holds damped_oscillator's members)."""
    case = get_case("bridge")
    cfg = TrainConfig().with_preset(case.presets["DPIVAE-A"]).replace(
        n_train=64, n_val=32, n_batch=16, n_mc_train=4, n_mc_val=4,
        n_iter=20, val_freq=10, use_seed=True, patience=10**9)
    dists, _ = make_square_dist(case)
    g = torch.Generator().manual_seed(5)
    data = [[sample_response(case, g, n, sample_dist=dists[i], device="cpu")
             for n in (cfg.n_train, cfg.n_val)] for i in range(2)]
    stack = lambda k: tuple(torch.stack([d[k][j] for d in data])
                            for j in range(3))
    res = train_sweep_data(cfg, case, [cfg.lambda_g0] * 2, stack(0), stack(1),
                           seed=11, chunk_size=None, device="cpu")
    assert res.logs.train.shape == (2, 20, 13)
    for m in range(2):
        gm = member_generators(11, [m], "cpu")[0]
        params = make_template_model(cfg, case, device="cpu").init(
            gm, device="cpu")
        model = setup_model(cfg, case, data[m][0], device="cpu")
        trained, logs = train_model(cfg, model, case, *data[m], params=params,
                                    generator=gm, device="cpu")
        torch.testing.assert_close(res.member_logs(m).train, logs.train,
                                   rtol=TOL, atol=TOL)
        for name, p in trained.state_dict().items():
            torch.testing.assert_close(res.params[name][m], p, rtol=TOL,
                                       atol=TOL)


def test_study_gpr_matches_sklearn_on_bridge_folds():
    """The GPR of ``--baselines sklearn`` (``fit_gpr_lbfgsb``: float64,
    L-BFGS-B) on the four extrapolation folds of one run at n_train 64
    gives scikit-learn's kernel parameters (rtol 1e-6) and predictions
    (rtol/atol 1e-8); on these folds the batched float32 fit stops far
    from that optimum."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF, WhiteKernel

    from dpivae_tpu_torch.eval import baselines as tb

    case = get_case("bridge")
    dists_test, dists_train = make_square_dist(case)
    g = torch.Generator().manual_seed(0)
    folds = [[sample_response(case, g, n, sample_dist=d[i], device="cpu")
              for n, d in ((64, dists_train), (32, dists_test))]
             for i in range(4)]
    tr, te = ([torch.stack([f[s][k] for f in folds]) for k in range(3)]
              for s in (0, 1))
    X_tr = tb._standardize_features(tr[0], tr[1], tr[0], tr[1])
    X_te = tb._standardize_features(tr[0], tr[1], te[0], te[1])
    pred, kparams = tb.fit_gpr_lbfgsb(X_tr, tr[2], X_te)
    _, kparams_batched = tb.fit_gpr_batched(X_tr, tr[2], X_te)
    assert pred.dtype == torch.float64 and pred.shape == (4, 32, case.nd_y)
    for m in range(4):
        f64 = lambda a: a[m].numpy().astype(np.float64)
        ref = GaussianProcessRegressor(RBF() + WhiteKernel()).fit(
            f64(X_tr), f64(tr[2]))
        np.testing.assert_allclose(kparams[m].numpy(),
                                   np.exp(ref.kernel_.theta), rtol=1e-6)
        np.testing.assert_allclose(pred[m].numpy(),
                                   ref.predict(f64(X_te)).reshape(32, -1),
                                   rtol=1e-8, atol=1e-8)
    far = np.abs(np.log(kparams_batched.numpy() / kparams.numpy())) > 0.1
    assert far.any(axis=1).sum() >= 2


# ----------------------------------------------------------------------
# The writer against pandas
# ----------------------------------------------------------------------

def _metrics(n_runs, seed):
    """A study's nested metrics: {run: {domain: {model: {R2, MSE, MAE}}}},
    per-output arrays as regression_metrics returns them."""
    rng = np.random.default_rng(seed)
    out = {}
    for j in range(n_runs):
        out[j] = {}
        for i in range(1, 5):
            out[j][i] = {name: {k: rng.normal(0.5, 0.4, 2).astype(np.float32)
                                * (1e-2 if k != "R2" else 1.0)
                                for k in ("R2", "MSE", "MAE")}
                         for name in ("DPIVAE-A", "DPIVAE-B", "LIN", "GPR",
                                      "MLP")}
    return out


def _pandas_files(metrics, n_runs, dist_type, tmp_path):
    """raw_metrics.csv and table.tex as the JAX script writes them
    (scripts/2_regression_comparison.py:236-289)."""
    list_domains = sorted(metrics[0].keys())
    list_models = list(metrics[0][list_domains[0]].keys())
    idx = pd.MultiIndex.from_product(
        [range(n_runs), list_domains, list_models],
        names=["Run", "Domain", "Model"])
    df_dom = pd.DataFrame(index=idx, columns=["R2", "MSE", "MAE"], dtype=float)
    for j, by_domain in metrics.items():
        for i, by_model in by_domain.items():
            for name, m in by_model.items():
                df_dom.loc[(j, i, name)] = [float(np.mean(m[k]))
                                            for k in ("R2", "MSE", "MAE")]
    df_run_agg = df_dom.groupby(level=["Domain", "Model"]).agg(["mean", "std"])
    df_dom_agg = df_dom.groupby(level=["Model"]).agg(["mean", "std"])

    def fmt(df_agg):
        out = pd.DataFrame(index=df_agg.index)
        for metric in ("R2", "MSE"):
            out[metric] = (df_agg[(metric, "mean")].map("{:.3f}".format)
                           + " $\\pm$ "
                           + df_agg[(metric, "std")].map("{:.3f}".format))
        return out

    csv_path = tmp_path / "pandas.csv"
    df_dom.to_csv(csv_path)
    caption = f"Comparison of model performance metrics in {dist_type}"
    tex = (fmt(df_run_agg).reset_index().to_latex(
        index=False, caption=caption, position="htb!") + "\n"
        + fmt(df_dom_agg).reset_index().to_latex(
            index=False, caption=caption + " (avg over domains)",
            position="htb!"))
    return csv_path.read_text(), tex


@pytest.mark.parametrize("n_runs", [6, 1])
def test_csv_and_latex_equal_pandas(n_runs, tmp_path):
    """The same text as pandas writes for the JAX script's aggregation of
    the same metrics; with one run every std is NaN ("nan")."""
    metrics = _metrics(n_runs, seed=n_runs)
    want_csv, want_tex = _pandas_files(metrics, n_runs, "interpolation",
                                       tmp_path)
    rows = transfer.metric_rows(metrics, n_runs)
    transfer.write_raw_metrics(str(tmp_path / "port.csv"), rows)
    assert (tmp_path / "port.csv").read_text() == want_csv
    assert transfer.tables_tex(rows, "interpolation") == want_tex


# ----------------------------------------------------------------------
# The program end to end
# ----------------------------------------------------------------------

def _read_rows(path):
    with open(os.path.join(path, "metrics", "raw_metrics.csv")) as f:
        return list(csv.reader(f))


def test_study_end_to_end_resumes_and_both_baselines(tmp_path, monkeypatch):
    """1 run x 4 domains, 30 steps: 20 rows with finite metrics for the
    five models, both tables, every phase timed; a rerun on the same
    output with --skip_baselines trains nothing and gives the same DPIVAE
    rows; --baselines sklearn (member by member) gives the batched fit's
    LIN rows."""
    steps = [0]
    step = train_mod.MemberTrainer.step_body

    def counted(self, *args, **kwargs):
        steps[0] += 1
        return step(self, *args, **kwargs)

    monkeypatch.setattr(train_mod.MemberTrainer, "step_body", counted)
    out = str(tmp_path)
    run = transfer.main([*TINY, "--baselines", "jax", "--output", out])
    assert steps[0] == 2 * 30
    rows = _read_rows(run.path)
    assert tuple(rows[0]) == transfer.CSV_COLUMNS
    assert len(rows) - 1 == 1 * 4 * 5 == len(run.rows)
    assert {r[2] for r in rows[1:]} == {"DPIVAE-A", "DPIVAE-B", "GPR", "LIN",
                                        "MLP"}
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[3:])
    tex = open(os.path.join(run.path, "metrics", "table.tex")).read()
    assert tex.count("\\begin{table}") == 2 and "(avg over domains)" in tex
    assert set(run.timings) == {"device_init", "train_DPIVAE-A",
                                "predict_DPIVAE-A", "train_DPIVAE-B",
                                "predict_DPIVAE-B", "baselines", "total"}
    assert sorted(os.listdir(run.path)) == [
        "chunks_DPIVAE-A", "chunks_DPIVAE-B", "metrics", "settings",
        "timings.json"]
    assert run.results["DPIVAE-A"].logs.train.shape == (4, 30, 13)
    x_train = run.data[0][0]
    assert x_train.shape == (4, 64, 64)

    steps[0] = 0
    again = transfer.main([*TINY, "--skip_baselines", "--output", out])
    assert steps[0] == 0
    dpivae = [r for r in rows[1:] if r[2].startswith("DPIVAE")]
    assert _read_rows(again.path)[1:] == dpivae
    assert "baselines" not in again.timings

    serial = transfer.main([*TINY, "--baselines", "sklearn", "--output", out])
    assert steps[0] == 0
    lin = lambda rs: np.array([[float(v) for v in r[3:]] for r in rs
                               if r[2] == "LIN"])
    np.testing.assert_allclose(lin(_read_rows(serial.path)[1:]),
                               lin(rows[1:]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flag, item", [
    # --n_devices above 1 needs the launcher (the id is the one the case
    # has always had, from when the mesh was not ported).
    pytest.param(["--n_devices", "2"], "torch.distributed.run --standalone",
                 id="flag0-item 11"),
    # --plot_domain is refused where matplotlib does not import, as on the
    # card's host (the id is the one the case has always had).
    pytest.param(["--plot_domain"], "--plot_domain needs matplotlib",
                 id="flag1-item 10"),
])
def test_study_refuses_what_is_not_ported(flag, item, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit):
        transfer.main(["--device", "cpu", *flag])
    assert item in capsys.readouterr().err
