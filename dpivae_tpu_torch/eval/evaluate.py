"""Evaluation paths (counterpart of dpivae_tpu/eval/evaluate.py).

The VAE's predictions and latents are MC means computed on the device by
``serving.sample_mean``, which runs only what the requested outputs need,
on CUDA as a CUDA graph cached by call signature (``cuda_graph="auto"``,
``utils/graph_cache.py``), as the JAX package runs them through its jit
cache (dpivae_tpu/eval/evaluate.py:58, :133).
The JAX package fits its comparison baselines and disentanglement probes
with scikit-learn on the host; here both run on the batched torch fits of
``eval/baselines.py`` and ``eval/probes.py`` with one member, on the device
of the params (the card has no scikit-learn): its GPR as scikit-learn fits
it (``fit_gpr_lbfgsb``) and its MLPs by scikit-learn's ``MLPRegressor``
rules (``eval/sklearn_mlp.py``).

Randomness comes from an explicit ``torch.Generator`` (default: seeded 0
on the params' device), or from ``noise``, the ready-made standard normals
of ``DPIVAE.sample`` (the seam through which tests replay the JAX
package's draws).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.cases import Case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.eval.baselines import run_comparison_batched
from dpivae_tpu_torch.eval.probes import (  # noqa: F401
    BLOCKS,
    batched_probe_scores,
    make_probe_regressor,
)
from dpivae_tpu_torch.models.vae import (
    DPIVAE,
    DPIVAEParams,
    Noise,
    bind_params,
)
from dpivae_tpu_torch.serving import sample_mean
from dpivae_tpu_torch.train.setup import make_template_model, setup_model
from dpivae_tpu_torch.utils import DeviceLike, to_numpy
from dpivae_tpu_torch.utils.metrics import regression_metrics


def build_eval_sample_fn(config: TrainConfig, case: Case, cond: bool,
                         n: int, slots=None, device: DeviceLike = None):
    """A ``sample_fn(state, data_train, x, c, noise)`` that returns
    ``model.sample``'s outputs of ``slots`` (default all nine) for one
    member: its params a ``DPIVAEParams`` state dict, its input scalers
    fitted on its own ``data_train``, its randomness the ``noise``
    mapping. Under ``torch.func.vmap`` one such function serves every
    member of a sweep (counterpart of dpivae_tpu/eval/evaluate.py:24-38,
    which refits the scalers in the trace the same way). ``device`` (None
    means CUDA) is where the params' structure is built."""
    slots = tuple(range(9)) if slots is None else tuple(slots)
    call = bind_params(make_template_model(config, case, device=device))

    def sample_fn(state, data_train, x, c, noise):
        model = setup_model(config, case, data_train, device=x.device)
        out = call(model, "sample", state, x, c, cond=cond, n=n,
                   grl_alpha=config.lambda_g0, noise=noise, slots=slots)
        return tuple(out[i] for i in slots)

    return sample_fn


def _inputs(params: DPIVAEParams, x, c, generator, noise):
    """x and c as f32 tensors on the params' device, and the generator
    (seeded 0 there when neither it nor noise is given)."""
    device = params.log_sigma_x.device
    x, c = (torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (x, c))
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return x, c, generator


def evaluate_model(
    config: TrainConfig,
    case: Case,
    model: DPIVAE,
    params: DPIVAEParams,
    data_test,
    cond: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Noise = None,
    cuda_graph="auto",
) -> Tuple[Dict[str, dict], Dict[str, np.ndarray]]:
    """Test-set regression metrics of the posterior-mean y over
    ``config.n_mc_test`` samples, keyed by ``config.name``. Runs no
    decoder_x (``sample_mean`` of "y" alone, with ``cuda_graph``)."""
    x, c, generator = _inputs(params, data_test[0], data_test[1], generator,
                              noise)
    (y_mean,) = sample_mean(model, params, x, c, outputs=("y",), cond=cond,
                            n=config.n_mc_test, grl_alpha=config.lambda_g0,
                            generator=generator, noise=noise,
                            cuda_graph=cuda_graph)
    y_pred = y_mean.cpu().numpy()
    metrics = regression_metrics(data_test[2], y_pred)
    return {config.name: metrics}, {config.name: y_pred}


def run_comparison(
    config: TrainConfig, case: Case, data_train, data_test,
    generator: Optional[torch.Generator] = None,
    models: Sequence[str] = ("LIN", "GPR", "MLP"),
    device: DeviceLike = None,
) -> Tuple[Dict[str, dict], Dict[str, np.ndarray]]:
    """The baselines LIN, GPR(RBF + White) and MLP(64, 64) on [x ‖ c]
    standardized by the train moments -> y, on ``device`` (None means
    CUDA): ``run_comparison_batched(baselines="sklearn")`` with one
    member, as the JAX package's scikit-learn ``run_comparison`` fits them:
    the GPR in float64 by L-BFGS-B (``fit_gpr_lbfgsb``), the MLP as
    ``MLPRegressor(hidden_layer_sizes=(64, 64), max_iter=10000)``
    (``fit_mlp_sklearn``, its draws from ``generator``). Returns (metrics,
    predictions) keyed by baseline."""
    del case  # the features and targets come from the data alone
    if np.shape(data_train[0])[0] != config.n_train:
        raise ValueError(f"n_train={config.n_train} but x_train has "
                         f"{np.shape(data_train[0])[0]} rows")
    if config.n_batch > config.n_train:
        raise ValueError("n_batch must be <= n_train")
    one = lambda data: tuple(
        (a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a)))
        [None] for a in data[:3])
    metrics, preds = run_comparison_batched(
        one(data_train), one(data_test), generator=generator,
        models=tuple(models), device=device, baselines="sklearn")
    return metrics[0], preds[0]


def sample_latents(
    config: TrainConfig,
    model: DPIVAE,
    params: DPIVAEParams,
    x,
    c,
    cond: bool = False,
    n: int = 1,
    generator: Optional[torch.Generator] = None,
    noise: Noise = None,
    cuda_graph="auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Posterior latents (z_x, z_c, z_y), MC means over ``n`` samples, as
    host numpy. Runs no decoder (``sample_mean``, with ``cuda_graph``)."""
    x, c, generator = _inputs(params, x, c, generator, noise)
    zx, zc, zy = sample_mean(model, params, x, c, outputs=BLOCKS, cond=cond,
                             n=n, grl_alpha=config.lambda_g0,
                             generator=generator, noise=noise,
                             cuda_graph=cuda_graph)
    return zx.cpu().numpy(), zc.cpu().numpy(), zy.cpu().numpy()


def fit_disentanglement_probes(
    latents_train: dict,
    latents_test: dict,
    z_train,
    z_test,
    factors,
    regressor: str = "linear",
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    **mlp_kwargs,
) -> List[list]:
    """Fit a probe (``make_probe_regressor``) from each latent block ("zx",
    "zc", "zy") to each factor, all at once on ``device`` (None means
    CUDA), and return ``[block, factor, test R²]`` rows, factor-major.

    ``latents_*`` map block names to (n, dim) arrays; ``z_*`` are (n,
    n_factors).
    """
    one = lambda a: a[None]  # numpy or tensor, as one member
    scores = batched_probe_scores(
        {b: one(latents_train[b]) for b in BLOCKS},
        {b: one(latents_test[b]) for b in BLOCKS},
        one(z_train), one(z_test), len(factors), regressor=regressor,
        generator=generator, device=device, **mlp_kwargs)
    return [[block, factor.name, float(scores[0, i, j])]
            for i, factor in enumerate(factors)
            for j, block in enumerate(BLOCKS)]


def disentanglement_metric(
    config: TrainConfig,
    model: DPIVAE,
    params: DPIVAEParams,
    case: Case,
    data_train,
    data_test,
    regressor: str = "linear",
    cond: bool = False,
    use_mean: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[Noise, Noise]] = None,
    mlp_kwargs: Optional[dict] = None,
) -> List[list]:
    """The paper's disentanglement score: for every ground-truth factor, a
    probe from each latent block (z_x, z_c, z_y) to the factor, and its
    test R². Returns rows ``[block, factor, score]``.

    The latents are one posterior sample per point (``config.n_mc_test``
    samples averaged with ``use_mean``), drawn from ``generator`` (the
    train split's, then the test split's), or taken from ``noise``, a pair
    of ``sample`` noise mappings for the two splits. The probes run on the
    params' device; ``mlp_kwargs`` go to the MLP probe (``max_iter`` for
    "mlp", ``n_epochs`` for "mlp_jax").
    """
    device = params.log_sigma_x.device
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)
    noise_train, noise_test = noise if noise is not None else (None, None)
    n = config.n_mc_test if use_mean else 1
    latents = [
        dict(zip(BLOCKS, sample_latents(config, model, params, data[0],
                                        data[1], cond=cond, n=n,
                                        generator=generator, noise=eps)))
        for data, eps in ((data_train, noise_train), (data_test, noise_test))
    ]
    return fit_disentanglement_probes(
        *latents, to_numpy(data_train[3]), to_numpy(data_test[3]),
        case.factors, regressor=regressor, generator=generator,
        device=device, **(mlp_kwargs or {}))
