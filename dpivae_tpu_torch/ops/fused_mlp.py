"""Fused two-layer MLP, linear -> ReLU -> linear (counterpart of
dpivae_tpu/ops/pallas_mlp.py).

``fused_mlp(x, w0, b0, w1, b1)`` computes ``relu(x @ w0.T + b0) @ w1.T + b1``
with weights in ``torch.nn.Linear`` layout (``w0: (H, d_in)``,
``w1: (d_out, H)``), over any leading dims of ``x``. It dispatches on the
device of ``x``:

- a CPU tensor goes to ``fused_mlp_reference``, the plain PyTorch version
  (the counterpart of ``_reference_mlp``);
- a CUDA tensor goes to the hand-written kernel in ``csrc/fused_mlp.cu``
  (the counterpart of the TPU kernel ``_mlp_kernel``), built with ``nvcc``
  for ``sm_90a`` at first use into ``build/dpivae_tpu_torch/`` and bound
  through its plain C interface with ``ctypes``. A build or launch failure
  raises; nothing falls back to the plain version on the card.

Only the forward pass is ported so far: a CUDA call that would need a
gradient raises ``NotImplementedError``. ``fused_mlp.launches`` counts the
kernel's launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
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


def fused_mlp_reference(x, w0, b0, w1, b1):
    """The plain PyTorch version: what the kernel is held against."""
    return F.linear(F.relu(F.linear(x, w0, b0)), w1, b1)


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


def build_library() -> Tuple[Path, str]:
    """Compile ``csrc/fused_mlp.cu`` into a shared library, unless one built
    from the same source and flags exists. Returns (library path, compiler
    output; empty when nothing was built)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libfused_mlp_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name and rename: concurrent builders never load a
    # half-written library.
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.fused_mlp_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fused_mlp_fwd.restype = ctypes.c_int
    lib.fused_mlp_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_mlp_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w0, b0, w1, b1) -> None:
    named = dict(x=x, w0=w0, b0=b0, w1=w1, b1=b1)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(
                f"fused_mlp: {name} is on {t.device}, x on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous")
    d_in = x.shape[-1]
    if w0.dim() != 2 or w1.dim() != 2 or x.dim() < 1 or d_in < 1:
        raise ValueError(
            f"fused_mlp: bad ranks x{tuple(x.shape)} w0{tuple(w0.shape)} "
            f"w1{tuple(w1.shape)}"
        )
    d_hidden, d_out = w0.shape[0], w1.shape[0]
    if (w0.shape[1] != d_in or tuple(b0.shape) != (d_hidden,)
            or tuple(w1.shape) != (d_out, d_hidden)
            or tuple(b1.shape) != (d_out,) or d_hidden < 1 or d_out < 1):
        raise ValueError(
            f"fused_mlp: inconsistent shapes x{tuple(x.shape)} "
            f"w0{tuple(w0.shape)} b0{tuple(b0.shape)} w1{tuple(w1.shape)} "
            f"b1{tuple(b1.shape)} (weights in nn.Linear (out, in) layout)"
        )


def fused_mlp(x, w0, b0, w1, b1):
    """y = relu(x @ w0.T + b0) @ w1.T + b1: plain PyTorch for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w0, b0, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_mlp takes CPU or CUDA tensors, got device {x.device}"
        )
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w0, b0, w1, b1)
    ):
        raise NotImplementedError(
            "fused_mlp on CUDA is forward-only: its backward (the hidden "
            "recompute kernel and an autograd.Function) comes with the "
            "training slice (ROADMAP.md, queue 2). Call it under "
            "torch.inference_mode() or torch.no_grad()."
        )
    _check(x, w0, b0, w1, b1)
    d_in, d_hidden, d_out = x.shape[-1], w0.shape[0], w1.shape[0]
    x2d = x.reshape(-1, d_in)
    rows = x2d.shape[0]
    out = torch.empty((rows, d_out), dtype=torch.float32, device=x.device)
    if rows:
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.fused_mlp_fwd(
                x2d.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), out.data_ptr(), rows, d_in, d_hidden, d_out,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err:
            smem = lib.fused_mlp_fwd_smem_bytes(d_in, d_hidden)
            raise RuntimeError(
                f"fused_mlp kernel launch failed: "
                f"{lib.fused_mlp_error_string(err).decode()} (rows={rows}, "
                f"d_in={d_in}, d_hidden={d_hidden}, d_out={d_out}, "
                f"{smem} bytes of shared memory per block)"
            )
        fused_mlp.launches += 1
    return out.reshape(*x.shape[:-1], d_out)


fused_mlp.launches = 0
