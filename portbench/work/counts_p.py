"""The benchmark's frozen count of the P model's work, from shapes alone
(the S model's is ``portbench/work/counts.py``, whose rules this keeps).

2 m k n FLOPs for every linear layer at the rows it runs on: the three
encoders over x (trunk, loc, log-sigma and tril heads) and the two priors
at the data points; decoder_x's data branch, the c and y decoders and the
partial-physics MLP (``physics.layers`` of the configuration: z_x and
the physical covariates in, tanh between) at the points times the
samples. Left out, as ``counts.py`` leaves them out: elementwise work
(activations, clamps, exponentials, the ELBO's reductions), the MVN
algebra of d <= 16, the optimizer's update and the random draws. A
training step counts the forward on the batch three times (forward and
backward), plus one validation forward amortised over ``val_freq``
steps.
"""

from __future__ import annotations

from portbench.work.counts import _dense, decoder_flops


def encoder_flops(cfg, rows: int) -> int:
    """The three full-covariance encoders, one a latent block."""
    E = cfg["encoder_hidden"]
    return sum(_dense(rows, cfg["nd_x"], E) + 2 * rows * E * (2 * n + n * n)
               for n in (cfg["nz_x"], cfg["nz_c"], cfg["nz_y"]))


def prior_flops(cfg, rows: int) -> int:
    P = cfg["prior_hidden"]
    return sum(_dense(rows, cfg[f"nd_{b}"], P)
               + 2 * rows * P * 2 * cfg[f"nz_{b}"] for b in "cy")


def physics_flops(cfg, rows: int) -> int:
    return _dense(rows, *cfg["physics"]["layers"])


def loss_forward_flops(cfg, points: int, mc: int) -> int:
    """One ELBO forward over ``points`` data points and ``mc`` samples."""
    return (encoder_flops(cfg, points) + prior_flops(cfg, points)
            + decoder_flops(cfg, points * mc)
            + physics_flops(cfg, points * mc))


def train_step_flops(cfg) -> float:
    """Model FLOPs of one optimizer step of one member, the validation
    amortised over its block."""
    return (3 * loss_forward_flops(cfg, cfg["n_batch"], cfg["n_mc_train"])
            + loss_forward_flops(cfg, cfg["n_val"], cfg["n_mc_val"])
            / cfg["val_freq"])
