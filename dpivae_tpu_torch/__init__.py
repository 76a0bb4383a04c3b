"""DPI-VAE in PyTorch for NVIDIA Hopper: the port of ``dpivae_tpu``.

The JAX package ``dpivae_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find:

- ``dpivae_tpu_torch.config``   — ``TrainConfig`` (dpivae_tpu/config.py).
- ``dpivae_tpu_torch.utils``    — distributions, priors, transforms, data
  generation, annealing schedules, early stopping (dpivae_tpu/utils/).
- ``dpivae_tpu_torch.physics``  — the analytic beam and oscillators
  (dpivae_tpu/physics/).
- ``dpivae_tpu_torch.cases``    — the ``simple_beam``,
  ``damped_oscillator`` and ``bridge`` cases (dpivae_tpu/cases/).
- ``dpivae_tpu_torch.ops``      — gradient reversal, MVN sampling, the
  hand-written CUDA fused-MLP kernels with their autograd function, and
  the decode's recompute (dpivae_tpu/ops/).
- ``dpivae_tpu_torch.models``   — encoders, decoders and ``DPIVAE``
  (dpivae_tpu/models/).
- ``dpivae_tpu_torch.train``    — ``setup_model``/``init_params``, the
  grouped Adam, ``train_model`` and checkpoints (dpivae_tpu/train/).
- ``dpivae_tpu_torch.eval``     — the VAE's test metrics, the LIN/GPR/MLP
  baselines and the disentanglement probes (dpivae_tpu/eval/).
- ``dpivae_tpu_torch.serving``  — the MC-posterior predictor and its
  ``torch.export`` serving artifact (dpivae_tpu/serving.py).
- ``dpivae_tpu_torch.sweep``    — member-batched sweeps
  (dpivae_tpu/sweep/).
- ``dpivae_tpu_torch.scripts``  — ``single_run``,
  ``disentanglement_metric`` and ``regression_comparison``, the
  programs of scripts/0_single_run.py, 1_disentanglement_metric.py and
  2_regression_comparison.py.
- ``dpivae_tpu_torch.examples`` — ``hyper_search``, ``custom_case``,
  ``serve_http`` and ``multichip_sweep``, the programs of examples/.
- ``dpivae_tpu_torch.convert``  — JAX params pytree and fitted scalers ->
  this package's.

This package imports neither ``jax`` nor ``dpivae_tpu``. Its entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from dpivae_tpu_torch.config import TrainConfig  # noqa: F401
