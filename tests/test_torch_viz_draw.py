"""The port's nine figures build and save on the CPU (matplotlib's Agg
backend), with the axes grids tests/test_viz.py asserts for the JAX
package's, from a briefly trained tiny simple_beam model; and the
annealing figure's program writes its PNG. KDE figures stay at n_plot
<= 50 and n_interp <= 3."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.scripts import plot_annealing
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.viz import (
    interp_corner_latent_space,
    plot_ground_truth_posterior,
    plot_interp_pred,
    plot_marginal_post,
    plot_marginal_prior,
    plot_pred,
    plot_regression_error,
    save_close_fig,
    visualize_training_loss,
)


@pytest.fixture(scope="module")
def trained():
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=64, n_val=32, n_batch=16, n_iter=20, val_freq=10,
        n_mc_train=2, n_mc_val=2, use_seed=True, n_interp=3, n_plot=50)
    gen = torch.Generator().manual_seed(0)
    dtr, dva = (sample_response(case, gen, n, sample_dist=case.gt_dist(),
                                device="cpu")
                for n in (cfg.n_train, cfg.n_val))
    model = setup_model(cfg, case, dtr, device="cpu")
    params, logs = train_model(cfg, model, case, dtr, dva,
                               params=init_params(cfg, model, device="cpu"),
                               generator=gen, device="cpu")
    return case, cfg, model, params, logs, dtr


def _saved(fig, path):
    save_close_fig(fig, str(path))
    assert path.exists() and path.stat().st_size > 0


def test_loss_curve(trained, tmp_path):
    _, _, _, _, logs, _ = trained
    fig, ax = visualize_training_loss(logs)
    assert len(ax) == 5
    _saved(fig, tmp_path / "loss.png")


def test_regression_error(trained, tmp_path):
    case, _, _, _, _, dtr = trained
    y = dtr[2]
    fig, ax = plot_regression_error(y, y.numpy() + 0.1, case,
                                    metrics={"R2": np.array([0.9])},
                                    title="VAE: Test")
    assert len(ax) == case.nd_y
    _saved(fig, tmp_path / "reg.png")


def test_ground_truth_posterior(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig = plot_ground_truth_posterior(model, params, cfg, case,
                                      case.gt_dist(), n_plot=50,
                                      device="cpu")
    # seaborn's pairplot: an n x n grid plus a twin axis per diagonal cell
    n_x = case.nz_x
    assert len(fig.axes) == n_x * n_x + n_x
    _saved(fig, tmp_path / "gt_post.png")


def test_interp_corner(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig = interp_corner_latent_space(model, params, cfg, case, 0, 2,
                                     n_plot=40, device="cpu")
    n_z = case.nz_x + cfg.nz_y
    assert len(fig.axes) == n_z * n_z + n_z
    _saved(fig, tmp_path / "corner.png")


def test_marginal_prior(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig, ax = plot_marginal_prior(model, params, cfg, case, n_plot=40,
                                  device="cpu")
    assert ax.shape == (cfg.nz_c + cfg.nz_y, len(case.factors))
    _saved(fig, tmp_path / "prior_marg.png")


def test_marginal_post(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig, ax = plot_marginal_post(model, params, cfg, case, n_plot=40,
                                 vars_interp=[0, 1], device="cpu")
    assert ax.shape == (case.nz_x + cfg.nz_c + cfg.nz_y, 2)
    _saved(fig, tmp_path / "post_marg.png")


def test_interp_pred(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig, ax = plot_interp_pred(model, params, cfg, case, n_plot=40,
                               device="cpu")
    assert ax.shape == (3, len(case.factors))
    _saved(fig, tmp_path / "interp_pred.png")


def test_pred_single_factor(trained, tmp_path):
    case, cfg, model, params, _, _ = trained
    fig, ax = plot_pred(model, params, cfg, case, 1, n_plot=40, device="cpu")
    assert len(ax) == 3
    _saved(fig, tmp_path / "pred.png")


def test_same_seed_same_figure_data(trained):
    """A figure's data come from its seed alone: the same seed draws the
    same traversal, another seed another."""
    from dpivae_tpu_torch.viz.visualization import pred_decomposition

    case, cfg, model, params, _, _ = trained
    draw = lambda seed: pred_decomposition(model, params, cfg, case, 0, 2,
                                           20, key=seed, device="cpu")[0]
    first, again, other = draw(3), draw(3), draw(4)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not torch.equal(first["xh_mean"], other["xh_mean"])


def test_plot_annealing_writes_png(tmp_path):
    out = tmp_path / "annealing.png"
    assert plot_annealing.main(["--n_iter", "200", "--out", str(out)]) == \
        str(out)
    assert out.exists() and out.stat().st_size > 0
