"""Command-line programs of the port (counterparts of the JAX package's
scripts/), run with ``python -m dpivae_tpu_torch.scripts.<name>``."""
