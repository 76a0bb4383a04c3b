"""Declarative case studies (counterpart of dpivae_tpu/cases/__init__.py).

A case is a frozen dataclass built on demand by ``get_case(name)``; all
three of the JAX package's cases are registered (``list_cases``). Frozen
surrogates are tanh MLPs over numpy weights read from the JAX package's
bundled archives by file path (reading a data file imports nothing).
``Case.fingerprint`` is a content digest of a case, which a saved model
keeps (train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.utils.priors import (
    factor_indices,
    get_prior_dist,
    get_shapes_from_factors,
    phys_covariate_indices,
)


@dataclasses.dataclass(frozen=True)
class Factor:
    """One ground-truth generative factor."""

    name: str
    lb: float
    ub: float
    dist: str  # "uniform" | "normal"
    args: Mapping[str, float]
    type: str  # "x" | "c" | "y" | "f"
    label: str
    val: float
    phys: bool = False


@dataclasses.dataclass(frozen=True)
class PriorSpec:
    """Fixed VAE prior on one z_x dim."""

    name: str
    lb: float
    ub: float
    dist: str
    args: Mapping[str, float]


def device_constants(copies: Dict, arrays: Sequence[np.ndarray],
                     like: torch.Tensor,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """``arrays`` as tensors of ``like``'s device and of ``dtype`` (by
    default ``like``'s), copied there on first use and kept in ``copies``:
    a copy from host memory on every call would make each call wait for
    the device. The copies are made outside inference mode, so that a
    first call under ``torch.inference_mode`` leaves tensors that autograd
    can still use.

    Under a trace (``torch.export``, ``torch.compile``) nothing is cached
    and the constants are made anew: there they are the tracer's own
    tensors, which become constants of the traced program and would fail
    every later eager call if they were kept."""
    dtype = like.dtype if dtype is None else dtype
    if torch.compiler.is_compiling():
        return tuple(torch.as_tensor(a, dtype=dtype, device=like.device)
                     for a in arrays)
    key = (like.device, dtype)
    if key not in copies:
        with torch.inference_mode(False):
            copies[key] = tuple(
                torch.as_tensor(a, dtype=dtype, device=like.device)
                for a in arrays)
    return copies[key]


@dataclasses.dataclass(frozen=True)
class Surrogate:
    """Frozen tanh MLP with an input StandardScaler, as a callable
    (counterpart of dpivae_tpu/cases/__init__.py:57-91).

    Weights are numpy constants in the JAX layout ``w: (in, out)``; compute
    follows the input's device and dtype (``device_constants``), so bf16
    latents run the surrogate in bf16, as in the JAX package.
    """

    params: Any  # {"layers": ({"w", "b"}, ...)}
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    _copies: Dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        layers = self.params["layers"]
        mean, scale, *wb = device_constants(
            self._copies,
            (self.scaler_mean, self.scaler_scale,
             *(a for layer in layers for a in (layer["w"], layer["b"]))),
            z)
        pairs = list(zip(wb[::2], wb[1::2]))
        h = (z - mean) / scale
        for w, b in pairs[:-1]:
            h = torch.tanh(h @ w + b)
        w, b = pairs[-1]
        return h @ w + b


@dataclasses.dataclass(frozen=True)
class Case:
    """A complete case study definition."""

    name: str
    factors: Tuple[Factor, ...]
    prior_x: Tuple[PriorSpec, ...]
    nd_x: int
    t_min: float
    t_max: float
    sigma_x: float
    sigma_c: float
    sigma_y: float
    full_model: Callable
    part_model: Callable
    presets: Mapping[str, Mapping[str, Any]]
    x_unit: str = ""
    y_unit: str = ""
    ylim: Tuple[float, float] = (-1.0, 1.0)
    # Simulator datasets, as in the JAX package's archives
    x_full: Optional[np.ndarray] = None
    y_full: Optional[np.ndarray] = None
    x_part: Optional[np.ndarray] = None
    y_part: Optional[np.ndarray] = None

    @property
    def shapes(self) -> Tuple[int, int, int, int, int]:
        """(nz_x, nd_c, nd_y, nd_f, nd_p)"""
        return get_shapes_from_factors(self.factors)

    @property
    def nz_x(self) -> int:
        return self.shapes[0]

    @property
    def nd_c(self) -> int:
        return self.shapes[1]

    @property
    def nd_y(self) -> int:
        return self.shapes[2]

    @property
    def nd_f(self) -> int:
        return self.shapes[3]

    @property
    def nd_p(self) -> int:
        return self.shapes[4]

    @property
    def t(self) -> np.ndarray:
        return np.linspace(self.t_min, self.t_max, self.nd_x)

    @property
    def idx_c_phys(self) -> Tuple[int, ...]:
        return tuple(phys_covariate_indices(self.factors))

    @property
    def z_idx_x(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "x"))

    @property
    def z_idx_c(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "c"))

    @property
    def z_idx_y(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "y"))

    def gt_dist(self):
        """Product ground-truth sampling distribution over all factors."""
        return get_prior_dist(self.factors)

    def prior_x_dist(self):
        """Fixed marginal prior over z_x."""
        return get_prior_dist(self.prior_x)

    def fingerprint(self) -> str:
        """Content digest of the case (counterpart of
        dpivae_tpu/cases/__init__.py:180-275; it need not equal the JAX
        package's digest of its own case): priors, factor table, physics
        and surrogate weights. ``save_model`` records it and ``load_model``
        warns when the case it restores against has another.

        Every field is hashed recursively with type-tagged length framing:
        scalars and strings by repr, arrays and tensors by bytes,
        dataclasses field by field (their per-device caches, fields that
        take no part in comparison, left out), functools.partial by
        (func, args, keywords), bound methods by (code, instance state),
        other callables by source (else qualname), closure cells and
        defaults. A function's module-level globals are not hashed.
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        h = hashlib.sha256()

        def tag(kind, payload: bytes):
            # Length framing: adjacent reprs must not run together
            h.update(b"<%s:%d>" % (kind.encode(), len(payload)))
            h.update(payload)

        def feed(o):
            if o is None or isinstance(o, (str, int, float, bool, bytes)):
                tag(type(o).__name__, repr(o).encode())
            elif isinstance(o, (np.ndarray, torch.Tensor)):
                a = (o.detach().cpu().numpy() if isinstance(o, torch.Tensor)
                     else o)
                tag("arr", str((a.shape, str(a.dtype))).encode())
                tag("buf", np.ascontiguousarray(a).tobytes())
            elif isinstance(o, (list, tuple)):
                tag("seq", str(len(o)).encode())
                for x in o:
                    feed(x)
            elif isinstance(o, (set, frozenset)):
                tag("set", str(len(o)).encode())
                for x in sorted(o, key=repr):
                    feed(x)
            elif isinstance(o, Mapping):
                tag("map", str(len(o)).encode())
                for k in sorted(o, key=repr):
                    feed(k)
                    feed(o[k])
            elif isinstance(o, functools.partial):
                tag("partial", b"")
                feed(o.func)
                feed(tuple(o.args))
                feed(dict(o.keywords))
            elif inspect.ismethod(o):
                tag("method", o.__func__.__qualname__.encode())
                feed(o.__func__)
                feed(getattr(o.__self__, "__dict__", repr(o.__self__)))
            elif dataclasses.is_dataclass(o) and not isinstance(o, type):
                tag("dc", type(o).__qualname__.encode())
                for f in dataclasses.fields(o):
                    if f.compare:
                        tag("field", f.name.encode())
                        feed(getattr(o, f.name))
            elif callable(o):
                try:
                    tag("src", inspect.getsource(o).encode())
                except (OSError, TypeError):
                    tag("qualname", getattr(
                        o, "__qualname__", type(o).__qualname__).encode())
                for cell in getattr(o, "__closure__", None) or ():
                    try:
                        feed(cell.cell_contents)
                    except ValueError:  # empty cell
                        pass
                for d in getattr(o, "__defaults__", None) or ():
                    feed(d)
            else:
                # Memory addresses stripped, so that the digest is stable
                # across processes
                tag("repr", re.sub(r"0x[0-9a-fA-F]+", "0x",
                                   repr(o)).encode())

        feed(self)
        digest = h.hexdigest()
        object.__setattr__(self, "_fingerprint", digest)  # frozen: memo
        return digest


_REGISTRY: Dict[str, Callable[[], Case]] = {}


def register_case(name: str):
    def wrap(builder: Callable[[], Case]):
        _REGISTRY[name] = builder
        return builder

    return wrap


def _register_all() -> None:
    # Imported lazily so that an artifact is read on first use
    from dpivae_tpu_torch.cases import (  # noqa: F401
        bridge,
        damped_oscillator,
        simple_beam,
    )


@functools.lru_cache(maxsize=None)
def get_case(name: str) -> Case:
    _register_all()
    if name not in _REGISTRY:
        raise KeyError(f"Unknown case {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_cases() -> Sequence[str]:
    _register_all()
    return sorted(_REGISTRY)
