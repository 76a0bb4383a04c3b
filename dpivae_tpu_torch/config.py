"""Typed run configuration (counterpart of dpivae_tpu/config.py:18-245).

A field-for-field copy of the JAX package's ``TrainConfig`` and
``AnnealingConfig``: same names, defaults, preset overlay, JSON round trip
and ``__post_init__`` validation, so every case preset and every saved
config applies unchanged. It is a copy, not an import: importing
``dpivae_tpu.config`` runs ``dpivae_tpu/__init__.py``, which imports jax.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Mapping, Optional


@dataclass(frozen=True)
class AnnealingConfig:
    """One annealing schedule spec."""

    type: Optional[str] = None  # None | "cyclical" | "sigmoid"
    n_cycles: int = 5
    R: float = 0.5
    mu: float = 0.15
    cov: float = 0.15


@dataclass(frozen=True)
class TrainConfig:
    """All run hyperparameters; names and defaults equal the JAX package's."""

    name: str = "default"
    use_seed: bool = False
    seed: int = 123

    # Models
    encoder_x: str = "NN"
    encoder_c: str = "NN"
    encoder_y: str = "NN"
    full_cov_prior: bool = False
    model_type: str = "S"  # "P" | "S" (set by presets)
    nz_c: int = 2
    nz_y: int = 2

    # Data, training and validation
    n_iter: int = 20_000
    n_train: int = 1024
    n_val: int = 512
    n_test: int = 512
    n_batch: int = 64
    n_mc_train: int = 16
    n_mc_val: int = 64
    n_mc_test: int = 512
    val_freq: int = 10

    # Disentanglement
    lambda_g0: float = 1 / 256
    beta_x0: float = 1.0
    beta_c0: float = 1.0
    beta_y0: float = 1.0
    lambda_x: Optional[float] = None
    alpha_x: float = 1.0
    alpha_c: float = 1.0
    alpha_y: float = 1.0

    # Optimization
    lr: float = 1e-3
    lr_e: float = 1e-3
    lr_ex: float = 1e-3
    lr_ec: float = 1e-3
    lr_ey: float = 1e-3
    lr_p: float = 1e-3
    lr_dx: float = 1e-3
    lr_dc: float = 1e-3
    lr_dy: float = 1e-3
    lr_sigma: float = 5e-3
    wd_e: float = 0.0
    wd_p: float = 0.0
    wd_dx: float = 0.0
    wd_dc: float = 0.0
    wd_dy: float = 0.0
    wd_sigma: float = 0.0
    clip_gradients: bool = False
    max_grad_norm: float = 1.0
    patience: int = 200
    min_delta: float = 0.001

    # Annealing (four independent schedules: λ, β_x, β_c, β_y)
    lambda_annealing: Optional[str] = None
    lambda_n_cycles: int = 5
    lambda_R: float = 0.5
    lambda_mu: float = 0.15
    lambda_cov: float = 0.15
    beta_x_annealing: Optional[str] = None
    beta_x_n_cycles: int = 5
    beta_x_R: float = 0.5
    beta_x_mu: float = 0.15
    beta_x_cov: float = 0.15
    beta_c_annealing: Optional[str] = None
    beta_c_n_cycles: int = 5
    beta_c_R: float = 0.5
    beta_c_mu: float = 0.15
    beta_c_cov: float = 0.15
    beta_y_annealing: Optional[str] = None
    beta_y_n_cycles: int = 4
    beta_y_R: float = 0.5
    beta_y_mu: float = 0.2
    beta_y_cov: float = 0.2

    # Plotting
    n_skip_plot_train: int = 0
    n_skip_plot_val: int = 0
    n_plot: int = 2000
    n_interp: int = 5

    # The CNN encoder's channels: input channels the signal is split
    # into, conv channels, and the trunk's output width
    ch_in: int = 1
    ch_out: int = 16
    ch_latent: int = 64

    # The fused-MLP kernel for the data-driven decoder branch:
    # False | True | "auto". In this package True is the hand-written CUDA
    # kernel (ops/fused_mlp.py), False plain PyTorch; "auto" picks the
    # kernel inside the band measured on the card (train/setup.py,
    # ops/fused_mlp.py auto_select) and plain PyTorch elsewhere.
    use_pallas: Any = "auto"
    # Override every MLP trunk width in the model; None keeps the
    # reference architecture.
    hidden_width: Optional[int] = None
    # Decode-path mixed precision: None (f32) or "bfloat16".
    compute_dtype: Optional[str] = None
    # Recompute the decode path in the backward pass.
    remat_decode: bool = False
    # Chunk the MC axis of the training loss's decode: None, a positive
    # int dividing n_mc_train and n_mc_val, or "auto".
    mc_chunk: Any = "auto"

    def __post_init__(self):
        # use_pallas is tri-state; anything else (e.g. the string "false"
        # from a hand-edited config JSON) would silently pass
        # bool(use_pallas) at model build and enable the kernel.
        if self.use_pallas not in (False, True, "auto"):
            raise ValueError(
                f"use_pallas must be False, True or 'auto', got "
                f"{self.use_pallas!r}"
            )
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(
                f"compute_dtype must be None or 'bfloat16', got "
                f"{self.compute_dtype!r}"
            )
        if self.mc_chunk is not None and self.mc_chunk != "auto":
            # bool is an int subclass; True would silently mean chunk=1.
            if (not isinstance(self.mc_chunk, int)
                    or isinstance(self.mc_chunk, bool)
                    or self.mc_chunk <= 0):
                raise ValueError(
                    f"mc_chunk must be None, a positive int or 'auto', got "
                    f"{self.mc_chunk!r}"
                )
            for fname in ("n_mc_train", "n_mc_val"):
                v = getattr(self, fname)
                if self.mc_chunk < v and v % self.mc_chunk:
                    raise ValueError(
                        f"mc_chunk={self.mc_chunk} must divide "
                        f"{fname}={v} (the loss scans over equal MC "
                        f"chunks; unequal tails would bias the MC mean)"
                    )
        if self.compute_dtype is not None and self.use_pallas is True:
            raise ValueError(
                "compute_dtype='bfloat16' is not supported together with "
                "use_pallas=True (the kernel is f32); set use_pallas=False "
                "or 'auto'"
            )

    def with_preset(self, preset: Mapping[str, Any]) -> "TrainConfig":
        """Overlay a case preset dict (unknown keys raise)."""
        unknown = set(preset) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"Unknown preset keys: {sorted(unknown)}")
        return dataclasses.replace(self, **dict(preset))

    def replace(self, **kwargs: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)

    def annealing(self, which: str) -> AnnealingConfig:
        """Bundle the four flat annealing fields for ``which`` in
        {"lambda", "beta_x", "beta_c", "beta_y"}."""
        return AnnealingConfig(
            type=getattr(self, f"{which}_annealing"),
            n_cycles=getattr(self, f"{which}_n_cycles"),
            R=getattr(self, f"{which}_R"),
            mu=getattr(self, f"{which}_mu"),
            cov=getattr(self, f"{which}_cov"),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls(**json.load(f))
