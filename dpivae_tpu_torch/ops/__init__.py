"""Core ops (counterpart of dpivae_tpu/ops/)."""
