"""The benchmark's frozen count of work, from shapes alone.

One count per operation, whatever implements it:

- The fused MLP (relu(x W0^T + b0) W1^T + b1, and the hidden layer alone
  that its backward recomputes): 2 rows (d_in H + H d_out) FLOPs, or
  2 rows d_in H for the hidden layer; inputs, weights and outputs read or
  written once each, 4 bytes a float. Its least time is the larger of the
  FLOPs at the TF32 peak and the bytes at the memory bandwidth: TF32 is the
  fastest unit of the card that can take part in an f32-accurate product,
  so no f32-correct kernel reads over 100 % against it.
- The model: 2 m k n for every linear layer of the encoder, the two
  priors and the three decoders at the rows they run on. Left out:
  elementwise work (activations, clamps, exponentials, the reductions of
  the ELBO), the MVN algebra of d <= 16 (matrix-vector products and the
  triangular solve, written elementwise), the physics decoder, the
  optimizer's update and the random draws.
- A training step counts the model's forward on the batch three times
  (forward and backward), plus one validation forward amortised over
  ``val_freq`` steps.

Peaks: NVIDIA's data sheet for the H100 SXM, dense.
"""

from __future__ import annotations

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def fused_mlp(rows: int, d_in: int, hidden: int, d_out: int):
    """(FLOPs, bytes) of one forward of the fused MLP over ``rows``."""
    flops = 2 * rows * (d_in * hidden + hidden * d_out)
    floats = (rows * d_in + hidden * d_in + hidden + d_out * hidden + d_out
              + rows * d_out)
    return flops, F32 * floats


def fused_mlp_hidden(rows: int, d_in: int, hidden: int):
    """(FLOPs, bytes) of the hidden layer relu(x W0^T + b0) alone."""
    flops = 2 * rows * d_in * hidden
    floats = rows * d_in + hidden * d_in + hidden + rows * hidden
    return flops, F32 * floats


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def _dense(rows, *sizes):
    return sum(2 * rows * a * b for a, b in zip(sizes, sizes[1:]))


def encoder_flops(cfg, rows: int) -> int:
    nz = cfg["nz_x"] + cfg["nz_c"] + cfg["nz_y"]
    H = cfg["encoder_hidden"]
    return _dense(rows, cfg["nd_x"], H) + 2 * rows * H * (2 * nz + nz * nz)


def prior_flops(cfg, rows: int) -> int:
    P = cfg["prior_hidden"]
    return sum(_dense(rows, cfg[f"nd_{b}"], P) + 2 * rows * P * 2 * cfg[f"nz_{b}"]
               for b in "cy")


def decoder_flops(cfg, rows: int, parts=("xh_d", "c", "y")) -> int:
    out = 0
    if "xh_d" in parts:
        out += _dense(rows, cfg["nz_c"] + cfg["nz_y"], cfg["decoder_x_hidden"],
                      cfg["nd_x"])
    for b in "cy":
        if b in parts:
            out += _dense(rows, cfg[f"nz_{b}"], cfg["decoder_aux_hidden"],
                          2 * cfg[f"nd_{b}"])
    return out


def loss_forward_flops(cfg, points: int, mc: int) -> int:
    """One ELBO forward over ``points`` data points and ``mc`` samples."""
    return (encoder_flops(cfg, points) + prior_flops(cfg, points)
            + decoder_flops(cfg, points * mc))


def train_step_flops(cfg) -> float:
    """Model FLOPs of one optimizer step of one run, the validation
    amortised over its block."""
    return (3 * loss_forward_flops(cfg, cfg["n_batch"], cfg["n_mc_train"])
            + loss_forward_flops(cfg, cfg["n_val"], cfg["n_mc_val"])
            / cfg["val_freq"])


def data_branch(cfg):
    """(d_in, hidden, d_out) of decoder_x's data branch."""
    return (cfg["nz_c"] + cfg["nz_y"], cfg["decoder_x_hidden"], cfg["nd_x"])


def train_block_fused_least_s(cfg) -> float:
    """Least time of a training block's fused-MLP launches: ``val_freq``
    forwards and hidden recomputes at the batch's rows and one validation
    forward."""
    d_in, H, d_out = data_branch(cfg)
    rows = cfg["n_batch"] * cfg["n_mc_train"]
    val_rows = cfg["n_val"] * cfg["n_mc_val"]
    return (cfg["val_freq"] * (least_seconds(*fused_mlp(rows, d_in, H, d_out))
                               + least_seconds(*fused_mlp_hidden(rows, d_in, H)))
            + least_seconds(*fused_mlp(val_rows, d_in, H, d_out)))
