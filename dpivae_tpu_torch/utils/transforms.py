"""Invertible transforms (counterpart of dpivae_tpu/utils/transforms.py:
24-241).

Every transform has ``forward(z) -> (z', log_det)`` and ``inverse``, with
the JAX package's log-det conventions (which follow the reference's,
including ShiftScale's broadcast forward log-det). Parameters are tensors
on the device the transform was built on; nothing updates in place.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


class StandardScaler:
    """forward: z -> (z - mean) / scale, log_det = -sum(log scale)
    inverse: z -> z * scale + mean,   log_det = +sum(log scale)
    """

    def __init__(self, mean: torch.Tensor, scale: torch.Tensor):
        self.mean = mean
        self.scale = scale

    @classmethod
    def fit(cls, sample: torch.Tensor) -> "StandardScaler":
        # Population std (ddof=0), as the JAX package and the reference.
        return cls(
            mean=torch.mean(sample, dim=0, keepdim=True),
            scale=torch.std(sample, dim=0, keepdim=True, correction=0),
        )

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        out = (z - self.mean) / self.scale
        log_det = -torch.sum(torch.log(self.scale)) * z.new_ones(z.shape[:-1])
        return out, log_det

    def inverse(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        out = z * self.scale + self.mean
        log_det = torch.sum(torch.log(self.scale)) * z.new_ones(z.shape[:-1])
        return out, log_det


class ShiftScale:
    """Affine map from the unit box to [lb, ub].

    forward: z -> z * (ub - lb) + lb, log_det = sum(log|ub - lb|)
    """

    def __init__(self, lb: torch.Tensor, ub: torch.Tensor):
        self.lb = lb
        self.ub = ub

    @property
    def a(self):
        return self.ub - self.lb

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        out = z * self.a + self.lb
        # log|a| broadcast over the full z shape, then summed over the last
        # dim: a constant sum(log|a|) per batch element.
        log_det = torch.sum(
            torch.log(torch.abs(self.a)) * torch.ones_like(z), dim=-1
        )
        return out, log_det

    def inverse(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        out = z / self.a - self.lb / self.a
        log_det = -torch.sum(torch.log(self.a)) * z.new_ones(z.shape[:-1])
        return out, log_det


class Logistic:
    """z -> sigmoid(k*z); log|det J| per element = k*z - 2*softplus(k*z)
    + log(k). The inverse is unimplemented, as in the reference."""

    def __init__(self, k: float = 1.0):
        self.k = k

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        kz = self.k * z
        log_det = torch.sum(
            kz - 2.0 * F.softplus(kz) + math.log(self.k), dim=-1
        )
        return torch.sigmoid(kz), log_det

    def inverse(self, z):
        raise NotImplementedError("Inverse not implemented for this transform")


class Chain:
    """Compose transforms, accumulating log-dets."""

    def __init__(self, *transforms):
        self.transforms = tuple(transforms)

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        log_det = z.new_zeros(z.shape[:-1])
        for t in self.transforms:
            z, ld = t.forward(z)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        log_det = z.new_zeros(z.shape[:-1])
        for t in reversed(self.transforms):
            z, ld = t.inverse(z)
            log_det = log_det + ld
        return z, log_det


# MaskedChain's index copies per mask, shared by its instances: a model
# set up anew inside a captured body (the sweeps' sampling graphs fit each
# member's scalers there) finds the copy made by an earlier call.
_MASK_COPIES: dict = {}


class MaskedChain:
    """Apply a transform chain only to the listed indices of the last axis;
    the other entries pass through unchanged."""

    def __init__(self, mask: Sequence[int], *transforms):
        self.mask = tuple(int(i) for i in mask)
        self.chain = Chain(*transforms)
        self._copies = _MASK_COPIES.setdefault(self.mask, {})

    def _apply(self, z, fn):
        # The index on z's device, copied there once: a copy from host
        # memory in every call would wait for the device, and a CUDA
        # graph cannot capture it.
        from dpivae_tpu_torch.cases import device_constants

        (idx,) = device_constants(self._copies, (self.mask,), z,
                                  dtype=torch.long)
        z_masked, log_det = fn(z.index_select(-1, idx))
        return z.index_copy(-1, idx, z_masked), log_det

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._apply(z, self.chain.forward)

    def inverse(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._apply(z, self.chain.inverse)


class Flip:
    """``transform`` with ``forward`` and ``inverse`` exchanged."""

    def __init__(self, transform):
        self.transform = transform

    def forward(self, z):
        return self.transform.inverse(z)

    def inverse(self, z):
        return self.transform.forward(z)


class Identity:
    """No-op transform: z unchanged, log_det 0."""

    def forward(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.as_tensor(z)
        return z, z.new_zeros(z.shape[:-1])

    def inverse(self, z) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.forward(z)
