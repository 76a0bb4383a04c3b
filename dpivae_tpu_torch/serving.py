"""The MC-posterior predictor (counterpart of dpivae_tpu/serving.py:36-79,
192-224).

``sample_mean`` computes MC means over ``n`` posterior samples of named
``DPIVAE.sample`` outputs, on the device, and only what those outputs
need. ``build_predict_fn`` closes over a model and its params and returns
a ``(x, c) -> tuple`` function of it; ``Predictor`` wraps that for host
callers: numpy (or tensor) requests in, a dict of numpy means out, with
the randomness seeded per request.

The JAX package's serialized artifact (``save_predictor``/
``load_predictor``, a StableHLO export) is not ported yet (ROADMAP.md,
queue 1, item 10).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dpivae_tpu_torch.utils import DeviceLike, resolve_device

# Named slots into the 9-tuple DPIVAE.sample returns.
SAMPLE_SLOTS = {
    "x_sample": 0,
    "xh_p": 1,
    "xh_d": 2,
    "c_sample": 3,
    "y": 4,
    "zx": 5,
    "zc": 6,
    "zy": 7,
}


def _slots(outputs: Sequence[str]):
    unknown = [o for o in outputs if o not in SAMPLE_SLOTS]
    if unknown:
        raise ValueError(
            f"unknown outputs {unknown}; choose from {sorted(SAMPLE_SLOTS)}"
        )
    return tuple(SAMPLE_SLOTS[o] for o in outputs)


def sample_mean(model, params, x, c, *, outputs: Sequence[str] = ("y",),
                cond: bool = False, n: int = 1, grl_alpha=None,
                generator=None, noise=None):
    """MC means over ``n`` posterior samples of the named ``model.sample``
    outputs, under ``torch.inference_mode()`` (counterpart of
    dpivae_tpu/utils/jit_cache.py:89-116).

    Only what the named outputs need is computed: XLA drops what the JAX
    package's program does not return, and eager PyTorch drops nothing by
    itself, so ``sample`` is asked for these slots alone ("y" runs no
    decoder_x, and so no fused-MLP kernel). The generator draws the same
    numbers as a full ``sample``, so each mean equals the full sample's
    mean bit for bit.
    """
    slots = _slots(outputs)
    with torch.inference_mode():
        out = model.sample(params, x, c, cond=cond, n=n, grl_alpha=grl_alpha,
                           generator=generator, noise=noise, slots=slots)
        return tuple(torch.mean(out[i], dim=0) for i in slots)


def build_predict_fn(model, params, config, *, cond: bool = False,
                     n: Optional[int] = None,
                     outputs: Sequence[str] = ("y",)):
    """A ``predict(x, c, *, generator=None, noise=None) -> tuple`` function.

    Each output is the MC mean over ``n`` posterior samples (default
    ``config.n_mc_test``) of the named ``model.sample`` slot
    (``sample_mean``), on the device of ``x``, ``c`` and the params.
    ``generator`` or ``noise`` supply the randomness, as in
    ``DPIVAE.sample``.
    """
    _slots(outputs)
    if n is None:
        n = config.n_mc_test

    def predict(x, c, *, generator=None, noise=None):
        return sample_mean(model, params, x, c, outputs=outputs, cond=cond,
                           n=n, grl_alpha=config.lambda_g0,
                           generator=generator, noise=noise)

    return predict


class Predictor:
    """Answers ``(x, c)`` requests with MC-posterior means on ``device``
    (None means CUDA); the model and params must live there."""

    def __init__(self, model, params, config, *, cond: bool = False,
                 n: Optional[int] = None, outputs: Sequence[str] = ("y",),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.outputs = tuple(outputs)
        self._predict = build_predict_fn(
            model, params, config, cond=cond, n=n, outputs=self.outputs
        )

    def __call__(self, x, c, *, seed: int = 0) -> Dict[str, np.ndarray]:
        """Predict for a batch; returns a dict of named numpy outputs."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        c = torch.as_tensor(c, dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = self._predict(x, c, generator=generator)
        return {name: v.cpu().numpy() for name, v in zip(self.outputs, out)}
