"""Model assembly (counterpart of dpivae_tpu/train/setup.py:116-305).

``setup_model`` wires the DPIVAE from a config, a case and the training
data: it fits the input StandardScalers, builds the fixed z_x prior and
the encoder output squash (Logistic -> ShiftScale into the prior bounds;
for the S model on the z_x slice of the joint latent only), selects the P
(three per-block encoders) or S (one joint encoder) model, and resolves
``use_pallas``/``mc_chunk``. ``make_template_model`` builds the same model
with input scalers that refuse to run, for restoring a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from dpivae_tpu_torch.cases import Case, device_constants
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.decoders import DECODER_X_HIDDEN
from dpivae_tpu_torch.models.vae import DPIVAE, DPIVAEParams
from dpivae_tpu_torch.ops.fused_mlp import auto_select
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

    lb, ub = _prior_bounds(case, x_train)
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

    # mc_chunk shapes only the training loss's decode; "auto" resolves to
    # None, since its JAX threshold is a TPU VMEM cliff.
    mc_chunk = None if config.mc_chunk == "auto" else config.mc_chunk
    use_pallas = resolve_use_pallas(
        config, case, mc_chunk,
        widths.get("decoder_x_hidden", DECODER_X_HIDDEN), device)

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


# The z_x prior's bounds by value, each set kept per device and dtype: a
# tensor made from host data on every call would be a copy from the host,
# which a CUDA graph cannot hold (the sweeps' sampling graphs run
# ``setup_model`` inside, under vmap, to fit each member's scalers).
_BOUNDS: Dict = {}


def _prior_bounds(case: Case, like: torch.Tensor):
    """The (lb, ub) of ``case.prior_x`` as float32 tensors on ``like``'s
    device."""
    bounds = tuple(np.asarray([getattr(p, side) for p in case.prior_x],
                              np.float32) for side in ("lb", "ub"))
    key = tuple(tuple(b.tolist()) for b in bounds)
    return device_constants(_BOUNDS.setdefault(key, {}), bounds, like,
                            torch.float32)


def resolve_use_pallas(config: TrainConfig, case: Case, mc_chunk,
                       d_hidden: int, device: torch.device) -> bool:
    """``use_pallas`` as a bool. "auto" resolves on the training shape of
    the one op the kernel covers, decoder_x's data branch: n_mc_train x
    n_batch rows, or mc_chunk x n_batch when the loss's decode is chunked,
    by ``ops.fused_mlp.auto_select`` on ``device`` (False on the CPU, and
    outside the band measured on the card). The choice then holds at every
    call site, validation and sampling included. With ``compute_dtype``
    set "auto" is False: the kernel is f32 (``use_pallas=True`` with
    ``compute_dtype`` already raised in ``TrainConfig``)."""
    if config.use_pallas != "auto":
        return bool(config.use_pallas)
    if config.compute_dtype is not None:
        return False
    mc_rows = config.n_mc_train
    if mc_chunk is not None:
        mc_rows = min(mc_rows, mc_chunk)
    return auto_select(rows=mc_rows * config.n_batch,
                       d_in=config.nz_c + config.nz_y, d_hidden=d_hidden,
                       d_out=case.nd_x, device=device)


class _UnfittedTransform:
    """Fail-loud stand-in for a template model's input transforms:
    ``transform_inputs`` takes None as identity, so a template with None
    transforms would silently skip the standardization."""

    def _raise(self, *args, **kwargs):
        raise RuntimeError(
            "this is a template model (make_template_model): its input "
            "transforms were never fitted to data. Give it the fitted "
            "scalers (train.checkpoint.load_model does) before calling "
            "loss/sample/forward."
        )

    forward = _raise
    inverse = _raise


def make_template_model(config: TrainConfig, case: Case,
                        device: DeviceLike = None) -> DPIVAE:
    """A DPIVAE on ``device`` (None means CUDA) whose input transforms
    raise on use: enough for ``init`` (the parameter shapes depend only on
    the dims) and for ``load_model``, which puts the saved scalers in."""
    device = resolve_device(device)
    dummy = tuple(torch.zeros((config.n_train, d), device=device)
                  for d in (case.nd_x, case.nd_c, case.nd_y))
    model = setup_model(config, case, dummy, device=device)
    sentinel = _UnfittedTransform()
    return dataclasses.replace(model, transform_x=sentinel,
                               transform_c=sentinel, transform_y=sentinel)


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
