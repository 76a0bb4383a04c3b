"""The S model's latent-Gaussian algebra as one op, forward and backward
(no counterpart in the JAX package, where XLA fuses this algebra into the
loss; ``csrc/latent_gauss.cu`` says why it is a kernel here).

``latent_gauss(enc, eps, prior_c, prior_y, squash, prior_x)`` takes the
raw outputs of the encoder's heads and of the two learned priors' heads
(``GaussianHead.heads``: mean, log-sigma, tril or None), the encoder
normals ``eps`` (n, rows, d), the z_x squash and the fixed z_x prior, and
returns ``(zx, zc, zy, KL_x)``: the squashed latents split by block, each
(n, rows, nz_*), and KL_x (rows,), the MC mean of log q - log|J| -
log p_x - log p_c - log p_y. ``DPIVAE.loss`` computes this with it (its
docstring says where).

It dispatches on the device of the tensors:

- CPU tensors go to ``latent_gauss_reference``, the plain composition
  (``gaussian_params``, ``mvn`` and the transforms), which the loss also
  runs under ``torch.func`` transforms;
- CUDA tensors go to ``LatentGaussFunction``: ``csrc/latent_gauss.cu``'s
  forward kernel, and under autograd its backward kernel, which
  recomputes from the saved inputs. The library is built with ``nvcc`` at
  first use into ``build/dpivae_tpu_torch/`` (as ``ops/fused_mlp.py``
  builds its own) and bound through its plain C interface with
  ``ctypes``. A build or launch failure raises; nothing falls back.

The kernels take float32, a latent width d = nz_x + nz_c + nz_y of at most
16, a squash ``MaskedChain`` over z_x's positions 0..nz_x-1 of
``Logistic`` then ``ShiftScale``, and a z_x prior whose dimensions are each
a ``Normal`` or a ``Uniform``. ``latent_gauss`` raises on anything else,
on either device.

``latent_fwd.launches`` and ``latent_bwd.launches`` count the kernels'
launches (a CUDA graph's replay adds its capture's, ``train/graph.py``);
while ``utils.spans`` records, each launch also counts
``latent.fused.fwd`` / ``latent.fused.bwd``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.models.encoders import (
    JITTER,
    gaussian_encoder_sample,
    gaussian_params,
)
from dpivae_tpu_torch.ops import fused_mlp as _fused
from dpivae_tpu_torch.ops.mvn import mvn_log_prob
from dpivae_tpu_torch.utils import GAUSSIAN_CONST, spans
from dpivae_tpu_torch.utils.distributions import (
    MarginalDistribution,
    Normal,
    Uniform,
)
from dpivae_tpu_torch.utils.transforms import Logistic, MaskedChain, ShiftScale

SOURCE = _fused.SOURCE.parent / "latent_gauss.cu"
# Without fused multiply-adds, each product and sum rounds on its own, as
# the plain version's separate kernels do.
NVCC_FLAGS = (*_fused.NVCC_FLAGS, "-fmad=false")
MAX_DIMS = 16

Head = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def latent_gauss_reference(enc: Head, eps, prior_c: Head, prior_y: Head,
                           squash, prior_x: MarginalDistribution):
    """The plain version: the loss's composition of the encoder sample,
    the squash, the three prior densities and the MC mean."""
    loc, tril = gaussian_params(*enc)
    z, dens_z = gaussian_encoder_sample(loc, tril, eps.shape[0], eps=eps,
                                        output_transform=squash)
    nz_x, nz_c = prior_x.n_z, prior_c[0].shape[-1]
    zx, zc, zy = z[..., :nz_x], z[..., nz_x: nz_x + nz_c], z[..., nz_x + nz_c:]
    log_prior_zx = torch.sum(prior_x.log_prob(zx), dim=-1)
    log_prior_zc = mvn_log_prob(zc, *gaussian_params(*prior_c))
    log_prior_zy = mvn_log_prob(zy, *gaussian_params(*prior_y))
    log_prior_z = log_prior_zx + log_prior_zc + log_prior_zy
    return zx, zc, zy, torch.mean(dens_z - log_prior_z, dim=0)


# The float table's head: gauss, jitter, k, log k, then dc_e, dc_c, dc_y
# and inv_n, which depend on the call's shapes.
_HEAD = 8


@functools.lru_cache(maxsize=None)
def _table(squash, prior_x) -> Optional[np.ndarray]:
    """The kernels' constants of a (squash, prior_x) pair; None where the
    pair is not one they take."""
    if not isinstance(prior_x, MarginalDistribution):
        return None
    nz_x = prior_x.n_z
    if not (isinstance(squash, MaskedChain)
            and squash.mask == tuple(range(nz_x))
            and len(squash.chain.transforms) == 2
            and isinstance(squash.chain.transforms[0], Logistic)
            and isinstance(squash.chain.transforms[1], ShiftScale)
            and 0 < nz_x <= MAX_DIMS):
        return None
    f32 = np.float32
    k = squash.chain.transforms[0].k
    table = np.zeros(_HEAD + 4 * MAX_DIMS, np.float32)
    table[:4] = (GAUSSIAN_CONST, JITTER, k, math.log(k))
    kind, p0, p1, p2 = (table[_HEAD + i * MAX_DIMS: _HEAD + (i + 1) * MAX_DIMS]
                        for i in range(4))
    for i, dist in enumerate(prior_x.distributions):
        # The constants as the plain version's CUDA kernels take them: a
        # Python float becomes float32, and a division by one becomes a
        # product with its float32 reciprocal.
        if isinstance(dist, Normal):
            kind[i] = 0
            p0[i], p1[i] = dist.loc, f32(1.0) / f32(dist.scale)
            p2[i] = math.log(dist.scale)
        elif isinstance(dist, Uniform):
            kind[i] = 1
            p0[i], p1[i] = dist.low, dist.high
            p2[i] = -math.log(dist.high - dist.low)
        else:
            return None
    return table


def _check(enc: Head, eps, prior_c: Head, prior_y: Head, squash,
           prior_x) -> np.ndarray:
    """Raise on what the op does not take; the pair's constants."""
    table = _table(squash, prior_x)
    if table is None:
        raise ValueError(
            "latent_gauss takes a MaskedChain(range(nz_x), Logistic, "
            "ShiftScale) squash and a MarginalDistribution of Normal and "
            "Uniform dimensions")
    named = {}
    for which, head in (("enc", enc), ("prior_c", prior_c),
                        ("prior_y", prior_y)):
        mean, log_sigma, tril = head
        m = mean.shape[-1]
        lead = tuple(mean.shape[:-1])
        want = ((*lead, m), (*lead, m), None if tril is None else
                (*lead, m * m))
        for part, t, shape in zip(("mean", "log_sigma", "tril"), head, want):
            if t is None:
                continue
            if tuple(t.shape) != shape or len(lead) != 1:
                raise ValueError(
                    f"latent_gauss: {which} {part} has shape "
                    f"{tuple(t.shape)}, expected {shape} with one row axis")
            named[f"{which} {part}"] = t
    d, rows = enc[0].shape[-1], enc[0].shape[0]
    nz_c, nz_y = prior_c[0].shape[-1], prior_y[0].shape[-1]
    if d > MAX_DIMS:
        raise ValueError(f"latent_gauss takes a latent width of at most "
                         f"{MAX_DIMS}, got {d}")
    if prior_x.n_z + nz_c + nz_y != d:
        raise ValueError(
            f"latent_gauss: the encoder's width {d} is not nz_x "
            f"{prior_x.n_z} + nz_c {nz_c} + nz_y {nz_y}")
    if any(t.shape[0] != rows for t in named.values()):
        raise ValueError("latent_gauss: the heads' row counts differ")
    shape = (eps.shape[0], rows, d)
    if eps.dim() != 3 or tuple(eps.shape) != shape:
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                         f"{shape}")
    named["eps"] = eps
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"latent_gauss: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != eps.device:
            raise ValueError(f"latent_gauss: {name} is on {t.device}, eps "
                             f"on {eps.device}")
    return table


def latent_gauss(enc: Head, eps, prior_c: Head, prior_y: Head, squash,
                 prior_x: MarginalDistribution):
    """(zx, zc, zy, KL_x): the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors (module docstring)."""
    table = _check(enc, eps, prior_c, prior_y, squash, prior_x)
    if eps.device.type == "cpu":
        return latent_gauss_reference(enc, eps, prior_c, prior_y, squash,
                                      prior_x)
    if eps.device.type != "cuda":
        raise ValueError(f"latent_gauss takes CPU or CUDA tensors, got "
                         f"device {eps.device}")
    shift = squash.chain.transforms[1]
    lb, ub = shift.lb, shift.ub
    for name, t in (("lb", lb), ("ub", ub)):
        if (t.dtype != torch.float32 or t.device != eps.device
                or t.numel() != prior_x.n_z or not t.is_contiguous()):
            raise ValueError(
                f"latent_gauss: the squash's {name} must be a contiguous "
                f"float32 tensor of {prior_x.n_z} values on {eps.device}")
    heads = tuple(t.contiguous() if t is not None else None
                  for t in (*enc, *prior_c, *prior_y))
    return LatentGaussFunction.apply(*heads, eps.contiguous(), lb, ub,
                                     _Shapes(table, prior_x.n_z, heads, eps))


class _Shapes:
    """A call's integer and float arguments of the C entries."""

    def __init__(self, table, nz_x: int, heads, eps):
        n, rows, d = eps.shape
        nz_c, nz_y = heads[3].shape[-1], heads[6].shape[-1]
        self.out = (nz_x, nz_c, nz_y)
        self.ints = [n, rows, d, nz_x, nz_c, nz_y,
                     *(int(heads[i] is not None) for i in (2, 5, 8)),
                     _mean_split(n, rows)]
        self.int_args = (ctypes.c_longlong * len(self.ints))(*self.ints)
        floats = table.copy()
        f32 = np.float32
        floats[4:_HEAD] = (d * GAUSSIAN_CONST, nz_c * GAUSSIAN_CONST,
                           nz_y * GAUSSIAN_CONST, f32(rows) / f32(n * rows))
        self.floats = (ctypes.c_float * len(floats))(*floats.tolist())


def _mean_split(n: int, rows: int) -> int:
    """Among how many threads ``torch.mean`` over the leading axis of an
    (n, rows) float32 tensor splits each output's n values on the card,
    as PyTorch's reduction kernel configures itself (its output vectors of
    up to 4, 512 threads a block, a split of the inputs only where each
    thread keeps 16 values or more): the forward kernel adds the MC mean
    in that order, so that KL_x rounds as the plain version's. Measured
    bit for bit at (16, 64) (no split) and (64, 512) (4). 0 where the
    kernel keeps an order of its own (a split above a warp, or more
    samples than it orders)."""
    pow2 = lambda v: 1 << (v.bit_length() - 1)
    vec = 4
    while vec > 1 and rows % vec:
        vec //= 2
    threads = 512 // vec
    dim0, dim1 = rows // vec, n
    dim0_pow2 = pow2(dim0) if dim0 < threads else threads
    dim1_pow2 = pow2(dim1) if dim1 < threads else threads
    width = min(dim0_pow2, 32)
    height = min(dim1_pow2, threads // width)
    split = height if (n >= height * 16 or n >= 256) else 1
    return split if split <= 32 and n <= 256 and n // split < 256 else 0


def _ptrs(tensors: Sequence[Optional[torch.Tensor]]):
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path = _fused.build_library(SOURCE, NVCC_FLAGS)[0]
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.latent_gauss_fwd.argtypes = [ptr] * 11
    lib.latent_gauss_fwd.restype = i32
    lib.latent_gauss_bwd.argtypes = [ptr] * 9
    lib.latent_gauss_bwd.restype = i32
    lib.latent_gauss_error_string.argtypes = [i32]
    lib.latent_gauss_error_string.restype = ctypes.c_char_p
    return lib


def _launch(entry: str, device, args, shapes) -> None:
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"{entry} kernel launch failed: "
            f"{lib.latent_gauss_error_string(err).decode()} (n, rows, d, "
            f"nz_x, nz_c, nz_y, full covariances, mean split: "
            f"{shapes.ints})")


def latent_fwd(heads, eps, lb, ub, shapes: _Shapes):
    """The forward kernel: (zx, zc, zy, KL_x)."""
    n, rows, _ = eps.shape
    zs = tuple(torch.empty((n, rows, w), dtype=torch.float32,
                           device=eps.device) for w in shapes.out)
    kl = torch.empty((rows,), dtype=torch.float32, device=eps.device)
    _launch("latent_gauss_fwd", eps.device,
            (_ptrs(heads), eps.data_ptr(), lb.data_ptr(), ub.data_ptr(),
             *(z.data_ptr() for z in zs), kl.data_ptr(), shapes.int_args,
             shapes.floats), shapes)
    latent_fwd.launches += 1
    spans.count("latent.fused.fwd")
    return (*zs, kl)


def latent_bwd(heads, eps, lb, ub, shapes: _Shapes, gzs, gkl):
    """The backward kernel: the grads of the nine raw head outputs (None
    for an absent tril)."""
    upstream = tuple(g.contiguous() for g in (*gzs, gkl))
    grads = tuple(None if h is None else torch.empty_like(h) for h in heads)
    _launch("latent_gauss_bwd", eps.device,
            (_ptrs(heads), eps.data_ptr(), lb.data_ptr(), ub.data_ptr(),
             _ptrs(upstream), _ptrs(grads), shapes.int_args, shapes.floats),
            shapes)
    latent_bwd.launches += 1
    spans.count("latent.fused.bwd")
    return grads


latent_fwd.launches = 0
latent_bwd.launches = 0


class LatentGaussFunction(torch.autograd.Function):
    """The CUDA op under autograd: the forward kernel saves its inputs, the
    backward kernel recomputes from them. ``eps`` and the squash's bounds
    take no grad."""

    @staticmethod
    def forward(ctx, em, es, ef, cm, cs, cf, ym, ys, yf, eps, lb, ub,
                shapes):
        heads = (em, es, ef, cm, cs, cf, ym, ys, yf)
        ctx.save_for_backward(*heads, eps, lb, ub)
        ctx.shapes = shapes
        return latent_fwd(heads, eps, lb, ub, shapes)

    @staticmethod
    def backward(ctx, gzx, gzc, gzy, gkl):
        *heads, eps, lb, ub = ctx.saved_tensors
        grads = latent_bwd(tuple(heads), eps, lb, ub, ctx.shapes,
                           (gzx, gzc, gzy), gkl)
        return (*grads, None, None, None, None)
