"""The MC-posterior predictor (counterpart of dpivae_tpu/serving.py:36-79,
192-224).

``build_predict_fn`` closes over a model and its params and returns a
``(x, c) -> tuple`` function whose outputs are MC means over ``n``
posterior samples, reduced on the device; ``Predictor`` wraps it for host
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


def build_predict_fn(model, params, config, *, cond: bool = False,
                     n: Optional[int] = None,
                     outputs: Sequence[str] = ("y",)):
    """A ``predict(x, c, *, generator=None, noise=None) -> tuple`` function.

    Each output is the MC mean over ``n`` posterior samples (default
    ``config.n_mc_test``) of the named ``model.sample`` slot, computed
    under ``torch.inference_mode()`` on the device of ``x``, ``c`` and the
    params. ``generator`` or ``noise`` supply the randomness, as in
    ``DPIVAE.sample``.
    """
    unknown = [o for o in outputs if o not in SAMPLE_SLOTS]
    if unknown:
        raise ValueError(
            f"unknown outputs {unknown}; choose from {sorted(SAMPLE_SLOTS)}"
        )
    if n is None:
        n = config.n_mc_test
    slots = tuple(SAMPLE_SLOTS[o] for o in outputs)

    def predict(x, c, *, generator=None, noise=None):
        with torch.inference_mode():
            out = model.sample(
                params, x, c, cond=cond, n=n, grl_alpha=config.lambda_g0,
                generator=generator, noise=noise,
            )
            return tuple(torch.mean(out[i], dim=0) for i in slots)

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
