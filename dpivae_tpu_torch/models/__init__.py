"""Model modules (counterpart of dpivae_tpu/models/)."""
