"""Model assembly (counterpart of dpivae_tpu/train/setup.py:116-252,299-305).

``setup_model`` wires the DPIVAE from a config, a case and the training
data: it fits the input StandardScalers, builds the fixed z_x prior and
the encoder output squash (Logistic -> ShiftScale into the prior bounds;
for the S model on the z_x slice of the joint latent only), selects the P
(three per-block encoders) or S (one joint encoder) model, and resolves
``use_pallas``/``mc_chunk``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpivae_tpu_torch.cases import Case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.vae import DPIVAE, DPIVAEParams
from dpivae_tpu_torch.utils import DeviceLike, resolve_device
from dpivae_tpu_torch.utils.transforms import (
    Chain,
    Logistic,
    MaskedChain,
    ShiftScale,
    StandardScaler,
)


def setup_model(config: TrainConfig, case: Case, data_train,
                device: DeviceLike = None) -> DPIVAE:
    """Assemble the DPIVAE model configuration on ``device`` (None means
    CUDA).

    Args:
        config: run hyperparameters (possibly preset-overlaid).
        case: the case study definition.
        data_train: (x, c, y[, z]) training arrays or tensors; the scalers
            are fitted on these.

    Returns:
        A ``DPIVAE``; call ``init_params`` (or ``.init``) for params.
    """
    device = resolve_device(device)
    x_train, c_train, y_train = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in data_train[:3]
    )

    if x_train.shape[0] != config.n_train:
        raise ValueError(
            f"n_train={config.n_train} but x_train has {x_train.shape[0]} rows"
        )
    if config.n_batch > config.n_train:
        raise ValueError("n_batch must be <= n_train")
    if case.nz_x != len(case.prior_x):
        raise ValueError("Prior distribution dimension mismatch with ground truth")
    for field in ("encoder_x", "encoder_c", "encoder_y"):
        choice = getattr(config, field)
        if choice not in ("NN", "CNN"):
            raise ValueError(f"Unknown {field} choice: {choice}")

    transform_x = StandardScaler.fit(x_train)
    transform_c = StandardScaler.fit(c_train)
    transform_y = StandardScaler.fit(y_train)

    lb = torch.tensor([p.lb for p in case.prior_x], dtype=torch.float32,
                      device=device)
    ub = torch.tensor([p.ub for p in case.prior_x], dtype=torch.float32,
                      device=device)
    if config.model_type == "P":
        output_transform_zx = Chain(Logistic(k=1.0), ShiftScale(lb, ub))
    elif config.model_type == "S":
        # The x-type factors occupy the leading indices by case convention
        if tuple(case.z_idx_x) != tuple(range(case.nz_x)):
            raise ValueError(
                "S model expects x-type factors first in the factor table"
            )
        output_transform_zx = MaskedChain(
            case.z_idx_x, Logistic(k=1.0), ShiftScale(lb, ub)
        )
    else:
        raise ValueError(f"Unknown model type {config.model_type}")

    widths = {}
    if config.hidden_width is not None:
        w = int(config.hidden_width)
        widths = dict(
            encoder_layers=(w,),
            encoder_layers_s=(w,),
            prior_net_layers=(w,),
            decoder_aux_layers=(w,),
            decoder_x_hidden=w,
        )

    # "auto" resolves to plain PyTorch: the JAX package's band for it was
    # measured on a TPU v5e and says nothing about this card; the kernel
    # earns an "auto" band only from a measurement on the card.
    use_pallas = config.use_pallas is True
    # mc_chunk shapes only the training loss's decode; "auto" resolves to
    # None, since its JAX threshold is a TPU VMEM cliff.
    mc_chunk = None if config.mc_chunk == "auto" else config.mc_chunk

    return DPIVAE(
        prior_x=case.prior_x_dist(),
        physics_model=case.part_model,
        nz_x=case.nz_x,
        nz_c=config.nz_c,
        nz_y=config.nz_y,
        nd_x=case.nd_x,
        nd_c=case.nd_c,
        nd_y=case.nd_y,
        idx_c_phys=case.idx_c_phys,
        model_type=config.model_type,
        full_cov_prior=config.full_cov_prior,
        lambda_x=config.lambda_x,
        encoder_x_arch=config.encoder_x,
        encoder_c_arch=config.encoder_c,
        encoder_y_arch=config.encoder_y,
        ch_in=config.ch_in,
        ch_out=config.ch_out,
        ch_latent=config.ch_latent,
        transform_x=transform_x,
        transform_c=transform_c,
        transform_y=transform_y,
        output_transform_zx=output_transform_zx,
        use_pallas=use_pallas,
        compute_dtype=config.compute_dtype,
        remat_decode=config.remat_decode,
        mc_chunk=mc_chunk,
        **widths,
    )


def init_params(config: TrainConfig, model: DPIVAE,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> DPIVAEParams:
    """Initialize params on ``device`` (None means CUDA), honoring the
    reference's opt-in seeding: without a generator, draws come from a CPU
    generator seeded with ``config.seed`` when ``config.use_seed``, else
    from a fresh random seed. A CPU generator gives the same weights on
    every device."""
    if generator is None:
        generator = torch.Generator()
        if config.use_seed:
            generator.manual_seed(config.seed)
        else:
            generator.seed()
    return model.init(generator, device=device)
