"""Fused two-layer MLP, linear -> ReLU -> linear, and its backward
(counterpart of dpivae_tpu/ops/pallas_mlp.py).

``fused_mlp(x, w0, b0, w1, b1)`` computes ``relu(x @ w0.T + b0) @ w1.T + b1``
with weights in ``torch.nn.Linear`` layout (``w0: (H, d_in)``,
``w1: (d_out, H)``), over any leading dims of ``x``. It dispatches on the
device of ``x``:

- a CPU tensor goes to ``fused_mlp_reference``, the plain PyTorch version
  (the counterpart of ``_reference_mlp``);
- a CUDA tensor goes to the hand-written kernel in ``csrc/fused_mlp.cu``
  (the counterpart of the TPU kernel ``_mlp_kernel``; its second layer
  runs on the TF32 tensor cores in the f32-accurate 3xTF32 split), built
  with ``nvcc`` for ``sm_90a`` at first use into ``build/dpivae_tpu_torch/`` and bound
  through its plain C interface with ``ctypes``. A build or launch failure
  raises; nothing falls back to the plain version on the card.

When autograd needs a gradient, ``fused_mlp`` goes through
``FusedMLPFunction``, the counterpart of the custom VJP
``_fused_mlp_fwd``/``_fused_mlp_bwd`` (pallas_mlp.py:202-222): the forward
saves its inputs and not the hidden activation, and the backward recomputes
it with ``fused_mlp_hidden`` (the counterpart of ``_mlp_hidden_kernel``,
the second kernel of ``csrc/fused_mlp.cu``; ``fused_mlp_hidden_reference``
on the CPU) before the plain matrix products of the gradients.

Both kernels also run member-batched: weights stacked on a leading member
axis (``w0`` (M, H, d_in), ``b0`` (M, H), ..., x (M, ..., d_in)) go to one
launch over a member grid axis, the counterpart of ``pallas_call``'s
batching rule under ``jax.vmap``; on the CPU the batched plain version
runs (``torch.baddbmm``). ``FusedMLPFunction`` and ``FusedMLPHidden`` are
``torch.autograd.Function``s in ``setup_context`` form with ``vmap``
rules, so ``torch.func.vmap(torch.func.grad(...))`` over single-member
code reaches the batched launches, one per call for all members.

``fused_mlp.launches`` and ``fused_mlp_hidden.launches`` count each
kernel's launches (a batched launch counts one), so a run can show that
it went through the kernels. A CUDA graph's replay (``train/graph.py``)
adds the launches its capture recorded, so a graphed loop counts as its
eager run does.

``auto_select`` resolves ``use_pallas="auto"`` for a call shape on a
device (the counterpart of ``auto_select``, pallas_mlp.py:124-176).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "fused_mlp.cu"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "dpivae_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# The band where use_pallas="auto" picks the kernel, measured on the card
# named below by chip_smoke.py (PERF.md §6): the forward
# beat plain PyTorch at every shape measured, 1,024 to 262,144 rows at
# 4 -> 128 -> 32 and 8 -> 128 -> 64 and 65,536 x (4 -> 256 -> 32), and
# the hidden recompute beat plain and torch._addmm_activation at 1,024 x
# (4 -> 128), 1,024 x (8 -> 128) and 65,536 x (4 -> 256). Outside the
# band, or on another card, "auto" keeps plain PyTorch.
_AUTO_DEVICE_NAME = "NVIDIA H100 80GB HBM3"
_AUTO_MAX_D_IN = 16
_AUTO_HIDDEN = (128, 256)
_AUTO_D_OUT = (32, 64)
_AUTO_ROWS = (1_000, 262_144)
_warned_device_names: set = set()


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def _device_name_matches(device: torch.device) -> bool:
    """True on the card the band was measured on; another card gets a
    one-time warning and False."""
    name = _device_name(device)
    if name == _AUTO_DEVICE_NAME:
        return True
    if name not in _warned_device_names:
        _warned_device_names.add(name)
        warnings.warn(
            f"use_pallas='auto': the kernel's band was measured on "
            f"{_AUTO_DEVICE_NAME!r} but this device is {name!r}; keeping "
            f"plain PyTorch. Measure with chip_smoke.py on this card and "
            f"update ops/fused_mlp.py's _AUTO_* constants (or set "
            f"use_pallas=True) if the kernel wins here."
        )
    return False


def auto_select(rows: int, d_in: int, d_hidden: int, d_out: int,
                device) -> bool:
    """Resolve ``use_pallas="auto"`` for a fused-MLP call shape on
    ``device``: True only on a CUDA device of the measured card and inside
    the measured band; False on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    in_band = (d_in <= _AUTO_MAX_D_IN and d_hidden in _AUTO_HIDDEN
               and d_out in _AUTO_D_OUT
               and _AUTO_ROWS[0] <= rows <= _AUTO_ROWS[1])
    return in_band and _device_name_matches(device)


def fused_mlp_reference(x, w0, b0, w1, b1):
    """The plain PyTorch version: what the kernel is held against. With
    member-stacked weights (``w0`` of rank 3, see ``fused_mlp``) it is the
    batched plain version, two ``torch.baddbmm``."""
    if w0.dim() == 3:
        x3 = _member_rows(x)
        h = F.relu(torch.baddbmm(b0[:, None], x3, w0.transpose(1, 2)))
        y = torch.baddbmm(b1[:, None], h, w1.transpose(1, 2))
        return y.reshape(*x.shape[:-1], w1.shape[1])
    return F.linear(F.relu(F.linear(x, w0, b0)), w1, b1)


def fused_mlp_hidden_reference(x, w0, b0):
    """The plain version of the hidden-layer recompute (batched over
    members for rank-3 ``w0``)."""
    if w0.dim() == 3:
        h = F.relu(torch.baddbmm(b0[:, None], _member_rows(x),
                                 w0.transpose(1, 2)))
        return h.reshape(*x.shape[:-1], w0.shape[1])
    return F.relu(F.linear(x, w0, b0))


def _member_rows(t):
    """(M, ..., d) -> (M, rows, d): one member's rows per leading index."""
    return t.reshape(t.shape[0], -1, t.shape[-1])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {home} or on PATH; set CUDA_HOME to the "
            f"CUDA toolkit to build {SOURCE.name}"
        )
    return found


def build_library(source: Path = SOURCE,
                  flags: Tuple[str, ...] = NVCC_FLAGS) -> Tuple[Path, str]:
    """Compile ``source`` (``csrc/fused_mlp.cu``, or another of the
    package's CUDA sources) with ``flags`` into a shared library, unless
    one built from the same source and flags exists. Returns (library
    path, compiler output; empty when nothing was built)."""
    digest = hashlib.sha256(
        Path(source).read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name and rename: concurrent builders never load a
    # half-written library.
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind_library(build_library()[0])


def bind_library(path) -> ctypes.CDLL:
    """Load a library built by ``build_library`` and declare its C entry
    points' arguments."""
    lib = ctypes.CDLL(str(path))
    ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    # rows, d_in, d_hidden, d_out, members and six member strides
    fwd_dims = [ll, i32, i32, i32, i32] + [ll] * 6
    lib.fused_mlp_fwd.argtypes = [ptr] * 6 + fwd_dims + [ptr]
    lib.fused_mlp_fwd.restype = i32
    lib.fused_mlp_fwd_on_path.argtypes = [ptr] * 6 + fwd_dims + [i32, ptr]
    lib.fused_mlp_fwd_on_path.restype = i32
    # rows, d_in, d_hidden, members and four member strides
    lib.fused_mlp_hidden.argtypes = [ptr] * 4 + [ll, i32, i32, i32] + [
        ll] * 4 + [ptr]
    lib.fused_mlp_hidden.restype = i32
    for name in ("fused_mlp_fwd_smem_bytes", "fused_mlp_hidden_smem_bytes"):
        getattr(lib, name).argtypes = [i32, i32]
        getattr(lib, name).restype = ctypes.c_size_t
    lib.fused_mlp_error_string.argtypes = [i32]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, weights, biases) -> None:
    """Raise on what the kernels do not take: dtype, device, and the shapes
    of x and each (weight, bias) layer in nn.Linear layout, single (rank-2
    weights) or stacked over a leading member axis (rank-3 weights, x and
    every bias with the same leading axis)."""
    tensors = dict(x=x)
    for i, (w, b) in enumerate(zip(weights, biases)):
        tensors[f"w{i}"], tensors[f"b{i}"] = w, b
    rank = weights[0].dim()
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        # Stacked over members, an array the members share may also be
        # broadcast (member stride 0, as expand leaves it).
        shared = (rank == 3 and t.dim() > 0 and t.stride(0) == 0
                  and t[0].is_contiguous())
        if not (t.is_contiguous() or shared):
            raise ValueError(f"{name}: {arg} must be contiguous")
    shapes = " ".join(f"{k}{tuple(t.shape)}" for k, t in tensors.items())
    lead = tuple(x.shape[:1]) if rank == 3 else ()
    if (rank not in (2, 3) or x.dim() < 1 + len(lead)
            or any(w.dim() != rank for w in weights)):
        raise ValueError(f"{name}: bad ranks {shapes}")
    width = x.shape[-1]
    for w, b in zip(weights, biases):
        if (width < 1 or w.shape[-1] != width or w.shape[-2] < 1
                or tuple(w.shape[:-2]) != lead
                or tuple(b.shape) != (*lead, w.shape[-2])):
            raise ValueError(
                f"{name}: inconsistent shapes {shapes} (weights in "
                f"nn.Linear (out, in) layout, member axis first when stacked)"
            )
        width = w.shape[-2]


def _members(tensors):
    """The member count and each (checked) tensor's per-member stride in
    elements: (1, [0, ...]) for a single call; for stacked tensors (M,
    ...) the elements of one member's part, or 0 for a tensor broadcast
    over the members."""
    if tensors[1].dim() == 2:
        return 1, [0] * len(tensors)
    return tensors[1].shape[0], [t.stride(0) and t[0].numel()
                                 for t in tensors]


def _launch(kernel: str, device, tensors, dims: Tuple[int, ...],
            members: int, strides: Tuple[int, ...]) -> None:
    """Launch the C entry ``kernel`` on the current stream of ``device``:
    the pointers of ``tensors`` (x, the weights and the output, in the
    entry's order), then ``dims``, the member count and ``strides``.
    Raises when the launch is refused."""
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, kernel)(
            *(t.data_ptr() for t in tensors), *dims, members, *strides,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{lib.fused_mlp_error_string(err).decode()} (shapes "
            f"{[tuple(t.shape) for t in tensors]}, arguments {dims}, "
            f"{members} members, strides {strides})"
        )


def _device_type(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_mlp takes CPU or CUDA tensors, got device {x.device}"
        )
    return x.device.type


def _forward(x, w0, b0, w1, b1, path=None):
    """The forward without autograd: plain PyTorch for CPU tensors, the
    CUDA kernel for CUDA tensors, on the path the launcher picks or, for
    ``path`` 0 or 1, on its split or staged path. Rank-3 weights stack M
    members: x (M, ..., d_in) -> (M, ..., d_out) in one launch."""
    if _device_type(x) == "cpu":
        return fused_mlp_reference(x, w0, b0, w1, b1)
    _check("fused_mlp", x, (w0, w1), (b0, b1))
    batched = w0.dim() == 3
    d_in, d_hidden, d_out = x.shape[-1], w0.shape[-2], w1.shape[-2]
    x3 = _member_rows(x) if batched else x.reshape(1, -1, d_in)
    n_members, rows = x3.shape[0], x3.shape[1]
    out = torch.empty((n_members, rows, d_out), dtype=torch.float32,
                      device=x.device)
    if rows and n_members:
        tensors = [x3 if batched else x3[0], w0, b0, w1, b1]
        members, strides = _members(tensors)
        tensors.append(out)
        strides = (*strides, rows * d_out if batched else 0)
        dims = (rows, d_in, d_hidden, d_out)
        if path is None:
            _launch("fused_mlp_fwd", x.device, tensors, dims, members,
                    strides)
        else:
            _launch("fused_mlp_fwd_on_path", x.device, tensors, dims,
                    members, (*strides, path))
        fused_mlp.launches += 1
    return out.reshape(*x.shape[:-1], d_out)


def fused_mlp_on_path(x, w0, b0, w1, b1, staged: bool):
    """The forward kernel on its staged path (``staged=True``) or its split
    path, whatever the row count: for timing the two paths against each
    other at one shape. The port's own calls go through ``fused_mlp``,
    whose launcher picks the path. CUDA tensors only; no autograd."""
    if _device_type(x) != "cuda":
        raise ValueError("fused_mlp_on_path takes CUDA tensors; the plain "
                         "version has no paths")
    return _forward(x, w0, b0, w1, b1, path=int(staged))


def fused_mlp_hidden(x, w0, b0):
    """h = relu(x @ w0.T + b0): plain PyTorch for CPU tensors, the CUDA
    kernel for CUDA tensors; rank-3 ``w0`` stacks members as in
    ``fused_mlp``, in one launch. The backward's recompute of the hidden
    layer, without autograd (``FusedMLPHidden`` is its autograd and vmap
    form)."""
    if _device_type(x) == "cpu":
        return fused_mlp_hidden_reference(x, w0, b0)
    _check("fused_mlp_hidden", x, (w0,), (b0,))
    batched = w0.dim() == 3
    d_in, d_hidden = x.shape[-1], w0.shape[-2]
    x3 = _member_rows(x) if batched else x.reshape(1, -1, d_in)
    n_members, rows = x3.shape[0], x3.shape[1]
    h = torch.empty((n_members, rows, d_hidden), dtype=torch.float32,
                    device=x.device)
    if rows and n_members:
        tensors = [x3 if batched else x3[0], w0, b0]
        members, strides = _members(tensors)
        tensors.append(h)
        strides = (*strides, rows * d_hidden if batched else 0)
        _launch("fused_mlp_hidden", x.device, tensors, (rows, d_in, d_hidden),
                members, strides)
        fused_mlp_hidden.launches += 1
    return h.reshape(*x.shape[:-1], d_hidden)


fused_mlp_hidden.launches = 0


def _to_front(info, t, bdim):
    """A vmap rule's input with its member axis first, contiguous: moved
    there, or, for an input shared by the members, broadcast (a stride-0
    view)."""
    if bdim is None:
        return t.contiguous().expand(info.batch_size, *t.shape)
    return t.movedim(bdim, 0).contiguous()


def _rows_of(t, batched):
    """(..., d) -> (rows, d), or (M, rows, d) when batched over members."""
    return _member_rows(t) if batched else t.reshape(-1, t.shape[-1])


class FusedMLPHidden(torch.autograd.Function):
    """``fused_mlp_hidden`` under autograd and ``torch.func``: the
    backward's recompute of h = relu(x @ w0.T + b0). Its vmap rule stacks
    the members and makes one batched launch, so ``vmap(grad(...))``
    through ``FusedMLPFunction`` reaches the batched hidden kernel. Its own
    backward (the ReLU-gated first layer's) serves only a second
    derivative."""

    @staticmethod
    def forward(x, w0, b0):
        return fused_mlp_hidden(x, w0, b0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w0, _ = inputs
        ctx.save_for_backward(x, w0, output)

    @staticmethod
    def backward(ctx, gh):
        x, w0, h = ctx.saved_tensors
        batched = w0.dim() == 3
        dz = _rows_of(gh * (h > 0.0), batched)
        x2 = _rows_of(x, batched)
        return ((dz @ w0).reshape(x.shape), dz.mT @ x2,
                torch.sum(dz, dim=-2))

    @staticmethod
    def vmap(info, in_dims, x, w0, b0):
        if w0.dim() + (in_dims[1] is None) != 3:
            raise ValueError("FusedMLPHidden's vmap rule takes single-member "
                             "weights under one vmap")
        args = [_to_front(info, t, d) for t, d in zip((x, w0, b0), in_dims)]
        return FusedMLPHidden.apply(*args), 0


class FusedMLPFunction(torch.autograd.Function):
    """``fused_mlp`` under autograd and ``torch.func``. The forward keeps x
    and the weights, not the (rows, H) hidden activation; the backward
    rebuilds it with ``FusedMLPHidden`` and forms the gradients with plain
    matrix products, as ``_fused_mlp_bwd`` leaves them to XLA. Its vmap
    rule is the counterpart of ``pallas_call``'s batching rule: the members
    stack on a leading axis and the forward kernel runs once for all of
    them."""

    @staticmethod
    def forward(x, w0, b0, w1, b1):
        return _forward(x, w0, b0, w1, b1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w0, b0, w1, b1 = ctx.saved_tensors
        batched = w0.dim() == 3
        x2, g2 = _rows_of(x, batched), _rows_of(g, batched)
        h = FusedMLPHidden.apply(x2, w0, b0)
        # dL/dh through the second linear, gated by the ReLU mask
        dh = (g2 @ w1) * (h > 0.0)
        dw1 = g2.mT @ h
        db1 = torch.sum(g2, dim=-2)
        dw0 = dh.mT @ x2
        db0 = torch.sum(dh, dim=-2)
        dx = (dh @ w0).reshape(x.shape)
        return dx, dw0, db0, dw1, db1

    @staticmethod
    def vmap(info, in_dims, x, w0, b0, w1, b1):
        if w0.dim() + (in_dims[1] is None) != 3:
            raise ValueError("FusedMLPFunction's vmap rule takes "
                             "single-member weights under one vmap")
        args = [_to_front(info, t, d)
                for t, d in zip((x, w0, b0, w1, b1), in_dims)]
        return FusedMLPFunction.apply(*args), 0


def fused_mlp(x, w0, b0, w1, b1):
    """y = relu(x @ w0.T + b0) @ w1.T + b1: plain PyTorch for CPU tensors,
    the CUDA kernel for CUDA tensors, through ``FusedMLPFunction`` (so
    under autograd and under ``torch.func.vmap``/``grad``). Rank-3 weights
    (M, out, in) with x (M, ..., in) run M members in one launch."""
    _device_type(x)
    return FusedMLPFunction.apply(x, w0, b0, w1, b1)


fused_mlp.launches = 0
