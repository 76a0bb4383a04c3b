"""The MC-posterior predictor and its serialized artifact (counterpart of
dpivae_tpu/serving.py).

``sample_mean`` computes MC means over ``n`` posterior samples of named
``DPIVAE.sample`` outputs, on the device, and only what those outputs
need. ``build_predict_fn`` closes over a model and its params and returns
a ``(x, c) -> tuple`` function of it; ``Predictor`` wraps that for host
callers: numpy (or tensor) requests in, a dict of numpy means out, with
the randomness seeded per request.

``save_predictor`` packages the predict path itself as a ``torch.export``
program (``<path>``, a ``.pt2`` archive) with a JSON sidecar
(``<path>.meta.json``), and ``load_predictor`` serves it with no model
code, case or checkpoint:

- the weights and the fitted scalers are baked in, from detached CPU
  copies, and the program is moved to the serving device at load, so one
  file serves on the CPU and on the card;
- the batch dimension is symbolic: one artifact serves any request size;
- the ABI is plain tensors: ``x`` (b, nd_x), ``c`` (b, nd_c), then the
  standard normals of the request, which take the place of the JAX
  artifact's raw key data: ``z`` (n, b, nz), ``z_prior`` (n, b, nz_c)
  with ``cond``, and the observation noise of the requested outputs only
  (``x``/``c``/``y``, (n, b, nd_*)). The outputs are MC means, reduced
  inside the program. ``ServedPredictor`` draws those normals from a
  generator seeded per request in the model's own order
  (``DPIVAE.noise_draws``, recorded as the sidecar's ``draws``, and drawn
  by ``draw_normals`` as ``DPIVAE.sample`` draws them), so an artifact
  answers as the live plain ``Predictor`` does under the same seed.

On a CUDA device every call replays a CUDA graph captured once per call
signature (``utils/graph_cache.py``, the counterpart of the JAX package's
jitted predict path): ``sample_mean`` and what is built on it, and the
loaded artifact, one graph per request shape. ``cuda_graph`` ("auto", the
default, True or False, as ``train.graph.resolve_cuda_graph`` reads it)
chooses: "auto" replays graphs on CUDA and runs eagerly on the CPU, True
raises on the CPU, False runs eagerly. Graphs give the eager answers bit
for bit under the same seeds.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.models.vae import OBSERVATION_NOISE
from dpivae_tpu_torch.train.graph import resolve_cuda_graph
from dpivae_tpu_torch.utils import DeviceLike, draw_normals, resolve_device
from dpivae_tpu_torch.utils.graph_cache import (
    cached_program,
    cached_sample_mean,
)

_FORMAT = "dpivae_tpu_torch.serving/1"

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


def _to_host(names, out) -> Dict[str, np.ndarray]:
    """Named outputs as numpy arrays, read back in one copy: one wait for
    the device instead of one per output."""
    flat = torch.cat([v.reshape(-1) for v in out]).cpu().numpy()
    ends = np.cumsum([v.numel() for v in out])[:-1]
    return {name: part.reshape(v.shape) for name, part, v in
            zip(names, np.split(flat, ends), out)}


def sample_mean(model, params, x, c, *, outputs: Sequence[str] = ("y",),
                cond: bool = False, n: int = 1, grl_alpha=None,
                generator=None, noise=None, cuda_graph="auto"):
    """MC means over ``n`` posterior samples of the named ``model.sample``
    outputs, under ``torch.inference_mode()`` (counterpart of
    dpivae_tpu/utils/jit_cache.py:89-116). On CUDA ("auto") through the
    graph cache's ``cached_sample_mean``, which copies ``generator``'s
    state in and the advanced state back, so that the generator ends
    where the eager call leaves it.

    Only what the named outputs need is computed: XLA drops what the JAX
    package's program does not return, and eager PyTorch drops nothing by
    itself, so ``sample`` is asked for these slots alone ("y" runs no
    decoder_x, and so no fused-MLP kernel). The generator draws the same
    numbers as a full ``sample``, so each mean equals the full sample's
    mean bit for bit.
    """
    slots = _slots(outputs)
    if resolve_cuda_graph(cuda_graph, x.device):
        return cached_sample_mean(model, params, x, c, cond=cond, n=n,
                                  grl_alpha=grl_alpha, outputs=slots,
                                  generator=generator, noise=noise)
    with torch.inference_mode():
        out = model.sample(params, x, c, cond=cond, n=n, grl_alpha=grl_alpha,
                           generator=generator, noise=noise, slots=slots)
        return tuple(torch.mean(out[i], dim=0) for i in slots)


def build_predict_fn(model, params, config, *, cond: bool = False,
                     n: Optional[int] = None,
                     outputs: Sequence[str] = ("y",), cuda_graph="auto"):
    """A ``predict(x, c, *, generator=None, noise=None) -> tuple`` function.

    Each output is the MC mean over ``n`` posterior samples (default
    ``config.n_mc_test``) of the named ``model.sample`` slot
    (``sample_mean``, with ``cuda_graph``), on the device of ``x``, ``c``
    and the params. ``generator`` or ``noise`` supply the randomness, as
    in ``DPIVAE.sample``.
    """
    _slots(outputs)
    if n is None:
        n = config.n_mc_test

    def predict(x, c, *, generator=None, noise=None):
        return sample_mean(model, params, x, c, outputs=outputs, cond=cond,
                           n=n, grl_alpha=config.lambda_g0,
                           generator=generator, noise=noise,
                           cuda_graph=cuda_graph)

    return predict


class Predictor:
    """Answers ``(x, c)`` requests with MC-posterior means on ``device``
    (None means CUDA); the model and params must live there. With
    ``cuda_graph`` "auto" (on CUDA) or True each request replays the
    graph of its shape, captured at its first request; True raises on
    the CPU."""

    def __init__(self, model, params, config, *, cond: bool = False,
                 n: Optional[int] = None, outputs: Sequence[str] = ("y",),
                 device: DeviceLike = None, cuda_graph="auto"):
        self.device = resolve_device(device)
        self.outputs = tuple(outputs)
        resolve_cuda_graph(cuda_graph, self.device)
        self._predict = build_predict_fn(
            model, params, config, cond=cond, n=n, outputs=self.outputs,
            cuda_graph=cuda_graph)

    def __call__(self, x, c, *, seed: int = 0) -> Dict[str, np.ndarray]:
        """Predict for a batch; returns a dict of named numpy outputs."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        c = torch.as_tensor(c, dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = self._predict(x, c, generator=generator)
        return _to_host(self.outputs, out)


# ----------------------------------------------------------------------
# The serialized artifact
# ----------------------------------------------------------------------

# Where an artifact may be loaded: it is exported on the CPU and moved.
_DEVICES = ("cpu", "cuda")


def _cpu_copy(obj):
    """A copy of a fitted transform (``StandardScaler``, ``Chain``, ...)
    with its tensors detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple):
        return tuple(_cpu_copy(o) for o in obj)
    if not hasattr(obj, "__dict__"):
        return obj
    out = copy.copy(obj)
    out.__dict__.update({k: _cpu_copy(v) for k, v in vars(obj).items()})
    return out


class _PredictProgram(torch.nn.Module):
    """The predict path as a module for ``torch.export``: the params a
    submodule (they become the program's weights), the model's scalers
    closed over (they become its constants)."""

    def __init__(self, model, params, *, slots, noise_names, cond, n,
                 grl_alpha):
        super().__init__()
        self.params = params
        self.model, self.slots, self.noise_names = model, slots, noise_names
        self.cond, self.n, self.grl_alpha = cond, n, grl_alpha

    def forward(self, x, c, *noise):
        out = self.model.sample(
            self.params, x, c, cond=self.cond, n=self.n,
            grl_alpha=self.grl_alpha, slots=self.slots,
            noise=dict(zip(self.noise_names, noise)))
        return tuple(torch.mean(out[i], dim=0) for i in self.slots)


def _noise_inputs(model, slots, cond: bool, n: int, batch) -> list:
    """(name, shape) of the artifact's noise inputs, ``batch`` in the batch
    place."""
    inputs = [("z", (n, batch, model.nz_x + model.nz_c + model.nz_y))]
    if cond:
        inputs.append(("z_prior", (n, batch, model.nz_c)))
    inputs += [(name, (n, batch, getattr(model, width)))
               for slot, name, width in OBSERVATION_NOISE if slot in slots]
    return inputs


def export_predictor(model, params, config, case=None, *,
                     cond: bool = False, n: Optional[int] = None,
                     outputs: Sequence[str] = ("y",)):
    """Export the predict path as a ``torch.export.ExportedProgram`` and
    its meta dict (the sidecar).

    The program is traced on the CPU from detached copies of the params
    and the fitted scalers, with a symbolic batch dimension (min 1). A
    ``use_pallas`` model is exported through the plain PyTorch decode, with
    a one-time warning: the CUDA kernel is called through ctypes, which
    ``torch.export`` cannot trace (the JAX package makes the same switch
    for its Pallas kernel, dpivae_tpu/serving.py:93-109). Served values
    then match the kernel path to the kernel's tolerance against plain
    (rtol/atol 1e-5 on the card), not bit for bit.
    """
    slots = _slots(outputs)
    if n is None:
        n = config.n_mc_test
    if getattr(model, "use_pallas", False):
        warnings.warn(
            "export_predictor: use_pallas=True model exported through the "
            "plain PyTorch decode (torch.export cannot trace the ctypes CUDA "
            "kernel); served values match the kernel path to its tolerance "
            "against plain (rtol/atol 1e-5), not bit for bit.",
            stacklevel=2)
    model = dataclasses.replace(model, use_pallas=False, **{
        name: _cpu_copy(getattr(model, name))
        for name in ("transform_x", "transform_c", "transform_y",
                     "output_transform_zx")})
    params = copy.deepcopy(params).to("cpu").requires_grad_(False)
    noise = _noise_inputs(model, slots, cond, n, 2)
    program = _PredictProgram(
        model, params, slots=slots, noise_names=tuple(k for k, _ in noise),
        cond=cond, n=n, grl_alpha=config.lambda_g0)
    example = (torch.zeros(2, model.nd_x), torch.zeros(2, model.nd_c),
               *(torch.zeros(shape) for _, shape in noise))
    b = torch.export.Dim("b", min=1)
    dynamic = ({0: b}, {0: b}, tuple({1: b} for _ in noise))
    with torch.no_grad():
        exported = torch.export.export(program, example,
                                       dynamic_shapes=dynamic, strict=False)
    spec = lambda name, shape: {"name": name, "shape": list(shape),
                                "dtype": "float32"}
    meta = {
        "format": _FORMAT,
        "outputs": list(outputs),
        "cond": bool(cond),
        "n_mc": int(n),
        "lambda_g0": float(config.lambda_g0),
        "nd_x": int(model.nd_x),
        "nd_c": int(model.nd_c),
        "inputs": [spec("x", ("b", model.nd_x)), spec("c", ("b", model.nd_c)),
                   *(spec(name, shape) for name, shape in _noise_inputs(
                       model, slots, cond, n, "b"))],
        "draws": [[name, int(width)]
                  for name, width in model.noise_draws(cond)],
        "exported_on": "cpu",
        "devices": list(_DEVICES),
        "torch_version": torch.__version__,
        "config": json.loads(config.to_json()),
    }
    if case is not None:
        meta.update(case=case.name, case_fingerprint=case.fingerprint())
    return exported, meta


def save_predictor(path: str, model, params, config, case=None, *,
                   cond: bool = False, n: Optional[int] = None,
                   outputs: Sequence[str] = ("y",)) -> str:
    """Export (``export_predictor``) and write ``<path>`` (the
    ``torch.export`` archive) and ``<path>.meta.json``; returns the
    artifact path."""
    exported, meta = export_predictor(model, params, config, case, cond=cond,
                                      n=n, outputs=outputs)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


@dataclasses.dataclass(frozen=True)
class ServedPredictor:
    """A loaded artifact on ``device``: what ``torch.export.load``
    returned (moved there) and its sidecar, nothing else. ``cuda_graph``
    as on ``Predictor``: "auto" replays one graph per request shape on
    CUDA (the cache's ``cached_program``); True raises on the CPU."""

    program: object
    meta: dict
    device: torch.device
    cuda_graph: object = "auto"

    def __post_init__(self):
        resolve_cuda_graph(self.cuda_graph, self.device)

    @property
    def outputs(self) -> Tuple[str, ...]:
        return tuple(self.meta["outputs"])

    @property
    def _module(self):
        module = self.__dict__.get("_module_cache")
        if module is None:
            module = self.program.module()
            object.__setattr__(self, "_module_cache", module)
        return module

    def __call__(self, x, c, *, seed: int = 0,
                 noise=None) -> Dict[str, np.ndarray]:
        """Predict for a batch; returns a dict of named numpy outputs.
        ``noise``, a mapping of standard normals as ``DPIVAE.sample`` takes
        it, replaces the draws from ``seed``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        c = torch.as_tensor(c, dtype=torch.float32, device=self.device)
        names = [i["name"] for i in self.meta["inputs"][2:]]
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        else:
            noise = {k: torch.as_tensor(noise[k], dtype=torch.float32,
                                        device=self.device) for k in names}
        if resolve_cuda_graph(self.cuda_graph, self.device):
            out = cached_program(self._module, self.meta, x, c,
                                 generator=generator, noise=noise)
        else:
            if noise is None:
                # The sidecar's ``draws`` are the model's ``noise_draws``
                noise = draw_normals(self.meta["draws"], generator,
                                     (self.meta["n_mc"], x.shape[0]),
                                     self.device)
            with torch.inference_mode():
                out = self._module(x, c, *(noise[k] for k in names))
        return _to_host(self.outputs, out)


def load_predictor(path: str, device: DeviceLike = None,
                   cuda_graph="auto") -> ServedPredictor:
    """Load a ``save_predictor`` artifact for serving on ``device`` (None
    means CUDA; raises without a card unless asked for the CPU), with
    ``cuda_graph`` as ``ServedPredictor`` takes it."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    path = os.path.abspath(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"{path!r} is not a dpivae_tpu_torch serving artifact "
            f"(format={meta.get('format')!r})")
    if device.type not in meta["devices"]:
        raise ValueError(f"the artifact loads on {meta['devices']}, not "
                         f"{device.type!r}")
    program = torch.export.load(path)
    if device.type != meta["exported_on"]:
        program = move_to_device_pass(program, str(device))
    return ServedPredictor(program=program, meta=meta, device=device,
                           cuda_graph=cuda_graph)
