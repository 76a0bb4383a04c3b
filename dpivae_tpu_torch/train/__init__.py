"""Model assembly (counterpart of dpivae_tpu/train/)."""

from dpivae_tpu_torch.train.setup import init_params, setup_model  # noqa: F401
