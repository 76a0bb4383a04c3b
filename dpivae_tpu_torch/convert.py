"""Carrying weights over from the JAX package.

The JAX package keeps params as a pytree of nested dicts and tuples, with
dense layers as ``{"w": (in, out), "b": (out,)}`` (dpivae_tpu/models/nn.py:
25-36) and 1-D convolutions as ``{"w": (kernel, ch_in, ch_out), "b"}``
(dpivae_tpu/models/encoders.py:55-66). This package keeps them in
``nn.Linear`` modules, weight (out, in), and ``Conv1dSame`` modules,
weight (ch_out, ch_in, kernel) as ``nn.Conv1d``'s. ``params_from_jax``
maps one onto the other; it takes the pytree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and imports no jax.
``scalers_from_jax`` carries a JAX model's fitted input scalers over with
them, so that a trained JAX model crosses whole.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from dpivae_tpu_torch.models.vae import DPIVAE, DPIVAEParams
from dpivae_tpu_torch.utils import DeviceLike, resolve_device
from dpivae_tpu_torch.utils.transforms import StandardScaler


def state_dict_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flatten a JAX params pytree into this package's state-dict names:
    dict keys and tuple indices join with "."; a layer's "w"/"b" become
    "weight" and "bias", a dense weight transposed to (out, in) and a
    convolution's (kernel, ch_in, ch_out) to (ch_out, ch_in, kernel)."""
    flat: Dict[str, torch.Tensor] = {}

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def walk(node, prefix):
        if isinstance(node, Mapping):
            if set(node) == {"w", "b"}:
                w = np.asarray(node["w"])
                if w.ndim not in (2, 3):
                    raise ValueError(
                        f"{prefix}w has {w.ndim} dims; a dense weight has 2, "
                        f"a 1-D convolution's 3"
                    )
                flat[prefix + "weight"] = tensor(w.T)
                flat[prefix + "bias"] = tensor(node["b"])
                return
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = tensor(node)

    walk(tree, "")
    return flat


def params_from_jax(model: DPIVAE, tree,
                    device: DeviceLike = None) -> DPIVAEParams:
    """The params of ``model`` (on ``device``, None meaning CUDA) loaded
    from a JAX params pytree. Every entry must match by name and shape,
    both ways."""
    params = model.init(torch.Generator().manual_seed(0), device=device)
    params.load_state_dict(state_dict_from_jax(tree), strict=True)
    return params


def scalers_from_jax(jax_model, device: DeviceLike = None
                     ) -> Dict[str, StandardScaler]:
    """The fitted input scalers of a JAX ``DPIVAE`` (its ``transform_x``,
    ``transform_c`` and ``transform_y``, each a ``StandardScaler`` with
    ``mean`` and ``scale``) as this package's, on ``device`` (None
    meaning CUDA): ``dataclasses.replace(model, **scalers_from_jax(m))``
    gives a port model that standardizes as the JAX one does."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    return {
        name: StandardScaler(mean=tensor(getattr(jax_model, name).mean),
                             scale=tensor(getattr(jax_model, name).scale))
        for name in ("transform_x", "transform_c", "transform_y")
    }
