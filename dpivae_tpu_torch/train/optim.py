"""Per-module optimizer (counterpart of dpivae_tpu/train/optim.py:25-111).

One Adam param group per ``DPIVAEParams`` submodule, each with its own
learning rate and L2 weight decay. ``torch.optim.Adam``'s ``weight_decay``
adds the decay to the gradient before the moments (not AdamW), with
b1 0.9, b2 0.999 and eps 1e-8: the JAX package's ``_grouped_adam``.
``MemberAdam`` is the same update for the stacked members of a sweep.

Both keep Adam's step count on the device and form the bias corrections
``1 - b^t`` there, in float64 as ``torch.optim.Adam``'s fused update does,
so an update reads no host value and can be captured in a CUDA graph
(``train/graph.py``); the eager loop runs the same update.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from dpivae_tpu_torch.config import TrainConfig


def group_fields(config: TrainConfig) -> Dict[str, Tuple[str, str]]:
    """The config fields (lr, wd) of each params group: the P model's
    encoders use lr_ex/lr_ec/lr_ey, the S model's one encoder lr_e, all
    with wd_e; prior nets share lr_p; decoders lr_dx/lr_dc/lr_dy; the
    noise scalar lr_sigma."""
    if config.model_type == "P":
        enc = {"encoder": ("lr_ex", "wd_e"), "encoder_c": ("lr_ec", "wd_e"),
               "encoder_y": ("lr_ey", "wd_e")}
    elif config.model_type == "S":
        enc = {"encoder": ("lr_e", "wd_e")}
    else:
        raise ValueError(f"Unknown model type {config.model_type}")
    return {
        **enc,
        "prior_net_c": ("lr_p", "wd_p"),
        "prior_net_y": ("lr_p", "wd_p"),
        "decoder_x": ("lr_dx", "wd_dx"),
        "decoder_c": ("lr_dc", "wd_dc"),
        "decoder_y": ("lr_dy", "wd_dy"),
        "log_sigma_x": ("lr_sigma", "wd_sigma"),
    }


def group_hparams(config: TrainConfig) -> Dict[str, Tuple[float, float]]:
    """(lr, wd) per params group, read from the fields ``group_fields``
    names."""
    return {name: (getattr(config, lr), getattr(config, wd))
            for name, (lr, wd) in group_fields(config).items()}


def make_optimizer(config: TrainConfig, params) -> torch.optim.Adam:
    """The grouped Adam over ``params`` (a ``DPIVAEParams``). With
    ``config.clip_gradients`` the caller clips with ``clip_grad_global_norm_``
    before each step.

    It is the fused update (one kernel per step on the card, one loop on
    the CPU), whose step counts are device tensors and whose Python side
    reads none of them; on CUDA it is also ``capturable``, which a CUDA
    graph's capture requires."""
    groups = group_hparams(config)
    names = {name for name, _ in params.named_children()} | {"log_sigma_x"}
    if names != set(groups):
        raise ValueError(
            f"params groups {sorted(names)} differ from the optimizer's "
            f"{sorted(groups)}"
        )
    param_groups = []
    for name, (lr, wd) in groups.items():
        member = getattr(params, name)
        tensors = ([member] if isinstance(member, torch.nn.Parameter)
                   else list(member.parameters()))
        param_groups.append(dict(params=tensors, lr=lr, weight_decay=wd))
    cuda = params.log_sigma_x.device.type == "cuda"
    optimizer = torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8,
                                 fused=True, capturable=cuda)
    _init_adam_state(optimizer)
    return optimizer


def _init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Makes each param's Adam state now, as ``torch.optim.Adam``'s first
    step would (zero moments, a zero step count on the param's device in
    the fused update's dtype), so that a training block can copy and
    restore it from the first block on (``train.train.Trainer``)."""
    from torch.optim.optimizer import _get_scalar_dtype

    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p].update(
                step=torch.zeros((), dtype=_get_scalar_dtype(is_fused=True),
                                 device=p.device),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(
                    p, memory_format=torch.preserve_format))


def adam_state_tensors(optimizer: torch.optim.Adam) -> List[torch.Tensor]:
    """Every tensor an update of ``make_optimizer``'s Adam changes: each
    param, its two moments and its step count."""
    return [t for group in optimizer.param_groups for p in group["params"]
            for t in (p, optimizer.state[p]["exp_avg"],
                      optimizer.state[p]["exp_avg_sq"],
                      optimizer.state[p]["step"])]


def clip_grad_global_norm_(parameters: Iterable[torch.Tensor],
                           max_norm: float) -> torch.Tensor:
    """Scale all gradients by max_norm / norm when their global norm
    exceeds max_norm, as ``optax.clip_by_global_norm`` does. Unlike
    ``torch.nn.utils.clip_grad_norm_`` (which divides by norm + 1e-6), a
    norm at or below max_norm leaves the gradients as they are. Stays on
    the device; returns the norm."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _group_of(name: str) -> str:
    """The optimizer group of a ``DPIVAEParams`` state-dict name: its
    submodule (``log_sigma_x`` is its own)."""
    return name.split(".", 1)[0]


class MemberAdam:
    """The grouped Adam of ``make_optimizer`` for M sweep members at once,
    with ``clip_grad_global_norm_``'s clip taken per member (counterpart of
    dpivae_tpu/train/optim.py under ``jax.vmap``).

    The members' params live in one flat (M, P) buffer; ``params`` maps
    each state-dict name to its (M, ...) view of it, and ``step`` updates
    the buffer in place. Learning rate, weight decay and the clip's
    ``max_grad_norm`` may differ per member (``hyper``: config field ->
    (M,) values, as in a hyperparameter sweep), so they are per-element
    (M, P) tensors and an (M,) norm limit, which ``torch.optim.Adam``
    cannot take. With the same values for every member each member's
    update is ``torch.optim.Adam``'s: decay added to the gradient before
    the moments, b1 0.9, b2 0.999, eps 1e-8, the step
    ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``. The step
    count ``t`` is a float64 device tensor shared by the members, and the
    bias corrections are formed from it on the device, in float64 (as
    the fused ``torch.optim.Adam`` of the single run forms them), then
    applied in float32.
    """

    BETAS = (0.9, 0.999)
    EPS = 1e-8

    def __init__(self, config: TrainConfig, params: Dict[str, torch.Tensor],
                 hyper: Optional[Dict[str, torch.Tensor]] = None):
        self.names = list(params)
        first = params[self.names[0]]
        self.n_members, device = first.shape[0], first.device
        hyper = hyper or {}
        fields = group_fields(config)
        unknown = {_group_of(n) for n in self.names} - set(fields)
        if unknown:
            raise ValueError(f"params groups {sorted(unknown)} have no "
                             f"optimizer group")
        self.flat = torch.cat([params[n].detach().reshape(self.n_members, -1)
                               for n in self.names], dim=1).contiguous()
        self.params = {}
        offset = 0
        for n in self.names:
            size = params[n][0].numel()
            self.params[n] = self.flat[:, offset:offset + size].view(
                params[n].shape)
            offset += size

        def per_member(field: str) -> torch.Tensor:
            if field in hyper:
                return torch.as_tensor(hyper[field], dtype=torch.float32,
                                       device=device).reshape(-1)
            return torch.full((self.n_members,), float(getattr(config, field)),
                              device=device)

        lr, wd = [], []
        for n in self.names:
            lr_f, wd_f = fields[_group_of(n)]
            size = params[n][0].numel()
            lr.append(per_member(lr_f)[:, None].expand(-1, size))
            wd.append(per_member(wd_f)[:, None].expand(-1, size))
        self.lr = torch.cat(lr, dim=1)
        self.wd = torch.cat(wd, dim=1)
        self.any_wd = bool((self.wd != 0).any())
        self.max_norm = (per_member("max_grad_norm")
                         if config.clip_gradients else None)
        self.exp_avg = torch.zeros_like(self.flat)
        self.exp_avg_sq = torch.zeros_like(self.flat)
        self.t = torch.zeros((), dtype=torch.float64, device=device)

    def flat_grads(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([grads[n].reshape(self.n_members, -1)
                          for n in self.names], dim=1)

    def clip(self, g: torch.Tensor) -> torch.Tensor:
        """(M, P) gradients with each member's scaled by max_norm / norm
        where its own global norm exceeds its max_norm (optax's
        ``clip_by_global_norm`` per member); as they are without
        ``clip_gradients``."""
        if self.max_norm is None:
            return g
        norm = torch.linalg.vector_norm(g, dim=1)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        return g * scale[:, None]

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of every member from its (M, ...) gradients."""
        g = self.clip(self.flat_grads(grads))
        if self.any_wd:
            g = g + self.wd * self.flat
        b1, b2 = self.BETAS
        self.t.add_(1)
        self.exp_avg.lerp_(g, 1 - b1)
        self.exp_avg_sq.mul_(b2).addcmul_(g, g, value=1 - b2)
        bias1 = 1 - torch.pow(b1, self.t)
        bias2 = 1 - torch.pow(b2, self.t)
        denom = (self.exp_avg_sq.sqrt() / bias2.sqrt()).add_(self.EPS)
        step = self.exp_avg * (self.lr / bias1)
        self.flat.addcdiv_(step, denom, value=-1.0)

    def state(self) -> Tuple[torch.Tensor, ...]:
        """A copy of what an update changes: params, both moments and the
        shared step count."""
        return (self.flat.clone(), self.exp_avg.clone(),
                self.exp_avg_sq.clone(), self.t.clone())

    def restore(self, members: torch.Tensor, state) -> None:
        """Put ``state`` (from ``state()``) back for the members where the
        (M,) bool device tensor ``members`` is True; the others keep
        theirs. The step count, which the members share, is put back only
        when every member's state is: a member kept at an earlier state is
        one whose training has stopped, and it reads the count no more.
        Reads no host value (it runs inside a training block's graph)."""
        keep = members[:, None]
        for now, then in zip((self.flat, self.exp_avg, self.exp_avg_sq),
                             state):
            torch.where(keep, then, now, out=now)
        torch.where(members.all(), state[3], self.t, out=self.t)
