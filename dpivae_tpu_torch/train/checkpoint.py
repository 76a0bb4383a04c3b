"""Checkpoints: save and restore params, and a servable model (counterpart
of dpivae_tpu/train/checkpoint.py).

The JAX package writes orbax directories; here a checkpoint is one file
written by ``torch.save``, a dict of CPU tensors read back with
``torch.load(..., weights_only=True)``:

- ``save_checkpoint``: ``{"params": state dict}``;
- ``save_model``: the same plus ``{"scalers": {"transform_x": {"mean",
  "scale"}, "transform_c": ..., "transform_y": ...}}``, the model's fitted
  input scalers, so that ``load_model`` rebuilds a ready-to-sample model
  from the file and the case alone.

Beside the file: ``<path>.config.json`` (the ``TrainConfig``) and, from
``save_model`` with a case, ``<path>.meta.json`` (case name and
``Case.fingerprint``; ``load_model`` warns when the case it restores
against has another).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import warnings
from typing import Optional, Tuple

import torch

from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.vae import DPIVAE, DPIVAEParams
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.utils import DeviceLike, resolve_device
from dpivae_tpu_torch.utils.transforms import StandardScaler

_SCALER_NAMES = ("transform_x", "transform_c", "transform_y")


def _cpu_state(params: DPIVAEParams):
    return {k: v.detach().cpu() for k, v in params.state_dict().items()}


def save_checkpoint(path: str, params: DPIVAEParams,
                    config: Optional[TrainConfig] = None) -> None:
    """Save the params at ``path`` (and the config beside it)."""
    path = os.path.abspath(path)
    torch.save({"params": _cpu_state(params)}, path)
    if config is not None:
        config.save_json(path + ".config.json")


def load_checkpoint(path: str, like: Optional[DPIVAEParams] = None):
    """The params saved by ``save_checkpoint``: a state dict of CPU
    tensors, or with ``like`` a copy of ``like`` (same device) holding
    them."""
    state = torch.load(os.path.abspath(path), weights_only=True)["params"]
    if like is None:
        return state
    params = copy.deepcopy(like)
    params.load_state_dict(state, strict=True)
    return params


def load_checkpoint_config(path: str) -> TrainConfig:
    return TrainConfig.from_json(os.path.abspath(path) + ".config.json")


def save_model(path: str, model: DPIVAE, params: DPIVAEParams,
               config: TrainConfig, case=None,
               extra_meta: Optional[dict] = None) -> None:
    """Save a servable checkpoint: the params and the model's fitted input
    scalers, the config beside them, and with ``case`` (or
    ``extra_meta``, JSON-serializable provenance) a ``.meta.json``
    holding the case's name and fingerprint."""
    path = os.path.abspath(path)
    scalers = {
        name: {"mean": getattr(model, name).mean.detach().cpu(),
               "scale": getattr(model, name).scale.detach().cpu()}
        for name in _SCALER_NAMES
    }
    torch.save({"params": _cpu_state(params), "scalers": scalers}, path)
    config.save_json(path + ".config.json")
    if case is not None or extra_meta:
        meta = dict(extra_meta or {})
        if case is not None:
            meta.update(case=case.name, case_fingerprint=case.fingerprint())
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_model(path: str, case, config: Optional[TrainConfig] = None,
               device: DeviceLike = None) -> Tuple[DPIVAE, DPIVAEParams]:
    """Rebuild a ready-to-sample ``(model, params)`` from ``save_model`` on
    ``device`` (None means CUDA).

    The architecture and the fixed pieces (priors, physics, squash) come
    from ``(config, case)`` as ``setup_model`` builds them, through
    ``make_template_model``; the input scalers come from the file.
    ``config`` defaults to the saved sidecar.
    """
    device = resolve_device(device)
    path = os.path.abspath(path)
    if config is None:
        config = load_checkpoint_config(path)
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        saved = meta.get("case_fingerprint")
        if saved is not None and saved != case.fingerprint():
            warnings.warn(
                f"checkpoint {path!r} was saved against case "
                f"{meta.get('case')!r} with a different content fingerprint "
                "— its priors, factor table, or surrogate weights have "
                "changed since; restored predictions may be inconsistent",
                stacklevel=2,
            )
    tree = torch.load(path, weights_only=True)
    template = make_template_model(config, case, device=device)
    scalers = {
        name: StandardScaler(mean=tree["scalers"][name]["mean"].to(device),
                             scale=tree["scalers"][name]["scale"].to(device))
        for name in _SCALER_NAMES
    }
    model = dataclasses.replace(template, **scalers)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    params.load_state_dict(tree["params"], strict=True)
    return model, params
