"""The programs' figures on the CPU, at tiny sizes: ``single_run --plots``
writes every figure file the JAX program writes, under its names;
``disentanglement_metric --plots`` and ``regression_comparison
--plot_domain`` write theirs; and ``--plots`` on a host without seaborn
stops at argument parsing, before any training, naming it."""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import pytest

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.scripts import (
    disentanglement_metric,
    regression_comparison,
    single_run,
)

TINY = ["--n_iter", "20", "--n_train", "64", "--n_val", "32", "--n_test",
        "32", "--device", "cpu"]


def test_single_run_plots_writes_the_jax_programs_figures(tmp_path):
    run = single_run.main(TINY + ["--n_plot", "30", "--n_interp", "2",
                                  "--plots", "--output", str(tmp_path)])
    n_factors = len(get_case("simple_beam").factors)
    want = ({"loss_curve.png", "fig_pred_interp_x.png",
             "fig_post_marginal_z.png", "fig_post_marginal_z_01.png",
             "fig_prior_marginal_z.png", "fig_posterior_ground_truth.png"}
            | {f"regression_error_test_{m}.png"
               for m in ("LIN", "GPR", "MLP", run.config.name)}
            | {f"fig_pred_x_{i}.png" for i in range(n_factors)})
    fig_dir = tmp_path / "single_run" / "figures"
    assert run.paths["figures"] == str(fig_dir)
    assert set(os.listdir(fig_dir)) == want
    assert all((fig_dir / f).stat().st_size > 0 for f in want)
    assert run.seconds["figures"] > 0


def test_plots_without_seaborn_stops_before_training(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setitem(sys.modules, "seaborn", None)
    with pytest.raises(SystemExit):
        single_run.main(TINY + ["--plots", "--output", str(tmp_path)])
    err = capsys.readouterr().err
    assert "--plots needs seaborn" in err and "without --plots" in err
    assert not (tmp_path / "single_run").exists()


def test_study_plots_writes_the_score_figure(tmp_path):
    study = disentanglement_metric.main(
        ["--lambdas", "1e-4", "0", "--n_runs", "2", "--n_iter", "10",
         "--n_train_regressor", "64", "--n_test_regressor", "64",
         "--device", "cpu", "--plots", "--output", str(tmp_path)])
    png = os.path.join(study.path, "disentanglement_score.png")
    assert os.path.getsize(png) > 0
    assert "figure" in study.timings


def test_transfer_plot_domain_writes_domains(tmp_path):
    transfer = regression_comparison.main(
        ["--n_runs", "1", "--n_iter", "5", "--n_train", "64", "--n_val",
         "16", "--n_test", "16", "--device", "cpu", "--skip_baselines",
         "--plot_domain", "--output", str(tmp_path)])
    png = os.path.join(transfer.path, "figures", "domains.png")
    assert os.path.getsize(png) > 0
