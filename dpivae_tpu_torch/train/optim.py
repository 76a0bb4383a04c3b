"""Per-module optimizer (counterpart of dpivae_tpu/train/optim.py:25-111).

One Adam param group per ``DPIVAEParams`` submodule, each with its own
learning rate and L2 weight decay. ``torch.optim.Adam``'s ``weight_decay``
adds the decay to the gradient before the moments (not AdamW), with
b1 0.9, b2 0.999 and eps 1e-8: the JAX package's ``_grouped_adam``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from dpivae_tpu_torch.config import TrainConfig


def group_hparams(config: TrainConfig) -> Dict[str, Tuple[float, float]]:
    """(lr, wd) per params group: the P model's encoders use lr_ex/lr_ec/
    lr_ey, the S model's one encoder lr_e, all with wd_e; prior nets share
    lr_p; decoders lr_dx/lr_dc/lr_dy; the noise scalar lr_sigma."""
    if config.model_type == "P":
        enc = {
            "encoder": (config.lr_ex, config.wd_e),
            "encoder_c": (config.lr_ec, config.wd_e),
            "encoder_y": (config.lr_ey, config.wd_e),
        }
    elif config.model_type == "S":
        enc = {"encoder": (config.lr_e, config.wd_e)}
    else:
        raise ValueError(f"Unknown model type {config.model_type}")
    return {
        **enc,
        "prior_net_c": (config.lr_p, config.wd_p),
        "prior_net_y": (config.lr_p, config.wd_p),
        "decoder_x": (config.lr_dx, config.wd_dx),
        "decoder_c": (config.lr_dc, config.wd_dc),
        "decoder_y": (config.lr_dy, config.wd_dy),
        "log_sigma_x": (config.lr_sigma, config.wd_sigma),
    }


def make_optimizer(config: TrainConfig, params) -> torch.optim.Adam:
    """The grouped Adam over ``params`` (a ``DPIVAEParams``). With
    ``config.clip_gradients`` the caller clips with ``clip_grad_global_norm_``
    before each step."""
    groups = group_hparams(config)
    names = {name for name, _ in params.named_children()} | {"log_sigma_x"}
    if names != set(groups):
        raise ValueError(
            f"params groups {sorted(names)} differ from the optimizer's "
            f"{sorted(groups)}"
        )
    param_groups = []
    for name, (lr, wd) in groups.items():
        member = getattr(params, name)
        tensors = ([member] if isinstance(member, torch.nn.Parameter)
                   else list(member.parameters()))
        param_groups.append(dict(params=tensors, lr=lr, weight_decay=wd))
    return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8)


def clip_grad_global_norm_(parameters: Iterable[torch.Tensor],
                           max_norm: float) -> torch.Tensor:
    """Scale all gradients by max_norm / norm when their global norm
    exceeds max_norm, as ``optax.clip_by_global_norm`` does. Unlike
    ``torch.nn.utils.clip_grad_norm_`` (which divides by norm + 1e-6), a
    norm at or below max_norm leaves the gradients as they are. Stays on
    the device; returns the norm."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
