"""The figures (counterpart of dpivae_tpu/viz/): the nine drawing
functions. Their data are computed on the device by the functions of
``viz.visualization``; matplotlib, seaborn and pandas are imported only
when a figure is drawn."""

from dpivae_tpu_torch.viz.visualization import (  # noqa: F401
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
