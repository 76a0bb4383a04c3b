"""Plain PyTorch reference of the DPI-VAE P model with an MLP physics
decoder and a physical covariate, float32 with TF32 off: the bridge case
at its preset "DPIVAE-A" (JanKoune/DPI-VAE, arXiv:2506.13658).

Written from the published model and the sizes in a configuration file of
``portbench/configs`` (``bridge_p_dpivae_a.json``):

- three full-covariance Gaussian encoders over the same standardised
  ``x``, one a latent block, each with its own sample ``loc + L eps`` and
  its log q from the noise;
- the logistic and shift-scale squash of ``z_x`` into the prior's box,
  with its log-determinant;
- the fixed uniform prior of ``z_x`` and the learned diagonal priors of
  ``z_c`` and ``z_y``;
- the partial physics, a frozen tanh MLP with its own input scaler over
  ``z_x`` and the raw physical covariates, tiled over the samples;
- the data branch over ``z_c || z_y`` through the gradient reversal at
  alpha = λ (λ = -1 in "DPIVAE-A": the reversal of a reversal, so the
  gradient passes unchanged), and the Gaussian c and y decoders;
- the Monte-Carlo ELBO with the joint KL estimate, and grouped Adam.

It imports nothing of the program under test; the shared pieces (the
reversal, the Gaussian densities, the triangular solve, the heads,
trunks and decoders, Adam's groups) come from
``portbench/reference/dpivae.py``. Every matrix product is ``F.linear``
or ``@`` on a weight, so ``torch.utils.flop_counter`` counts the linear
layers and the physics MLP, as ``portbench/work/counts_p.py`` does.

Departures from the paper's description, each as the published code has
it: the encoders' log q is formed from the standard normals, not by a
density evaluation at the sample; ``KL_x`` is one Monte-Carlo estimate
over all three latent blocks together, and ``KL_c``, ``KL_y`` and the
regulariser are logged as zero; the data-driven branch's input is
``z_c || z_y`` (the physics alone sees ``z_x``); the covariate the
physics reads is the raw column, not the standardised one; the
scale-tril diagonal carries a 1e-8 jitter and the heads are clamped
(loc ±50, log sigma [-7, 3], tril ±20).

Draws follow the program's documented protocol: a sweep member's
generator draws its weights (each weight, then its bias, in
initialisation order), then a step's batch rows as the top ``n_batch``
of ``n_train`` uniforms and the x, c and y encoders' normals in turn,
and one validation draw after each block's first step.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import dpivae as ref
from portbench.reference.dpivae import GAUSS, _mvn_lp, _normal_lp

ROOT = Path(__file__).resolve().parents[2]
BLOCKS = ("x", "c", "y")
ENCODERS = {"x": "encoder", "c": "encoder_c", "y": "encoder_y"}


def widths(cfg) -> Tuple[int, int, int]:
    return cfg["nz_x"], cfg["nz_c"], cfg["nz_y"]


def leaves(cfg) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every parameter of the P model, in the
    order it is initialised: the x, c and y encoders, the two priors,
    decoder_x, decoder_c, decoder_y, log_sigma_x (fan_in 0: zero)."""
    E, P, A = (cfg["encoder_hidden"], cfg["prior_hidden"],
               cfg["decoder_aux_hidden"])
    D = cfg["decoder_x_hidden"]

    def lin(prefix, fan_in, fan_out):
        return [(f"{prefix}.weight", (fan_out, fan_in), fan_in),
                (f"{prefix}.bias", (fan_out,), fan_in)]

    out = []
    for b, n in zip(BLOCKS, widths(cfg)):
        enc = ENCODERS[b]
        out += (lin(f"{enc}.trunk.layers.0", cfg["nd_x"], E)
                + lin(f"{enc}.f_mean", E, n) + lin(f"{enc}.f_sigma", E, n)
                + lin(f"{enc}.f_cov", E, n * n))
    for b in "cy":
        out += (lin(f"prior_net_{b}.trunk.layers.0", cfg[f"nd_{b}"], P)
                + lin(f"prior_net_{b}.f_mean", P, cfg[f"nz_{b}"])
                + lin(f"prior_net_{b}.f_sigma", P, cfg[f"nz_{b}"]))
    out += (lin("decoder_x.fx0", cfg["nz_c"] + cfg["nz_y"], D)
            + lin("decoder_x.fx1", D, cfg["nd_x"]))
    for b in "cy":
        out += (lin(f"decoder_{b}.layers.0", cfg[f"nz_{b}"], A)
                + lin(f"decoder_{b}.layers.1", A, 2 * cfg[f"nd_{b}"]))
    return out + [("log_sigma_x", (), 0)]


def n_params(cfg) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(cfg))


def seeded_init(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A member's starting weights from its generator: each weight, then
    its bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), one draw a leaf."""
    out = {}
    for name, shape, fan_in in leaves(cfg):
        if fan_in == 0:
            out[name] = torch.zeros(shape, device=generator.device)
            continue
        u = torch.rand(shape, generator=generator, device=generator.device)
        out[name] = (2.0 * u - 1.0) * (1.0 / math.sqrt(fan_in))
    return out


# ----------------------------------------------------------------------
# Data: the transfer study's quadrant domains
# ----------------------------------------------------------------------

def load_arrays(cfg, device, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The surrogate archive's tanh MLP ``prefix`` ("" the full physics,
    "part_" the partial physics) as {w0, b0, ..., scaler_mean,
    scaler_scale} on ``device``."""
    def wanted(k):
        return (k[:1] in ("w", "b") and k[1:].isdigit()
                or k.startswith("scaler_"))

    with np.load(ROOT / cfg["surrogate"]) as data:
        return {k[len(prefix):]: torch.as_tensor(data[k], dtype=torch.float32,
                                                 device=device)
                for k in data.files
                if k.startswith(prefix) and wanted(k[len(prefix):])}


def domain_box(cfg, domain: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) over every factor of the training box of ``domain``:
    in the study's extrapolation direction each domain trains on one
    quadrant of the physics factors' box, fold i on quadrant (3 - i) mod
    4 (quadrants 0-3: low/low, high/low, high/high, low/high), and every
    other factor over its whole box."""
    factors = cfg["factors"]
    low = [f["low"] for f in factors]
    high = [f["high"] for f in factors]
    phys = [i for i, f in enumerate(factors) if f["type"] == "x"]
    quadrant = (3 - domain) % 4
    upper = ((quadrant in (1, 2)), (quadrant in (2, 3)))
    for i, up in zip(phys, upper):
        mid = low[i] + (high[i] - low[i]) / 2
        low[i], high[i] = (mid, high[i]) if up else (low[i], mid)
    as_t = lambda v: torch.tensor(np.asarray(v, np.float32))
    return as_t(low), as_t(high)


def domain_response(cfg, arrays, generator: torch.Generator, n: int,
                    domain: int):
    """(x, c, y): ``n`` factor vectors uniform over ``domain``'s box (one
    draw of (n, factors)), the response from the full surrogate plus
    noise, then the c and y factors plus noise."""
    dev = generator.device
    low, high = (t.to(dev) for t in domain_box(cfg, domain))
    u = torch.rand((n, low.shape[0]), generator=generator, device=dev)
    z = low + (high - low) * u
    x = ref.surrogate(arrays, z)
    x = x + cfg["sigma_x"] * torch.randn(x.shape, generator=generator,
                                         device=dev)
    out = [x]
    for b in "cy":
        cols = [i for i, f in enumerate(cfg["factors"]) if f["type"] == b]
        v = z[:, cols]
        out.append(v + cfg[f"sigma_{b}"] * torch.randn(
            v.shape, generator=generator, device=dev))
    return tuple(out)


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

class Reference(ref.Reference):
    """The P model over a state dict ``p`` of ``leaves(cfg)``, with the
    input scalers fitted on ``data_train`` (population std) and the
    partial physics ``part`` (``load_arrays(cfg, device, "part_")``)."""

    def __init__(self, cfg, data_train, device, part):
        self.cfg = cfg
        self.device = device
        self.scalers = [(a.mean(0, keepdim=True),
                         a.std(0, keepdim=True, correction=0))
                        for a in data_train[:3]]
        px = cfg["prior_x"]
        self.lb = torch.tensor([d["lb"] for d in px], device=device)
        self.ub = torch.tensor([d["ub"] for d in px], device=device)
        self.part = part
        self.idx_c_phys = list(cfg["idx_c_phys"])

    def physics(self, zx, c):
        """The partial physics over ``z_x || c[..., idx_c_phys]``, the
        covariates tiled over the samples."""
        c_phys = c[..., self.idx_c_phys].expand(zx.shape[0], *c.shape[:-1],
                                                len(self.idx_c_phys))
        return ref.surrogate(self.part, torch.cat((zx, c_phys), -1))

    def encode(self, p, x_t, eps):
        """(zx, zc, zy, log q) for encoder normals ``eps`` (n, b, nz),
        whose slices are the x, c and y encoders' in that order."""
        parts = torch.split(eps, list(widths(self.cfg)), -1)
        zs, log_q = [], 0.0
        for b, e in zip(BLOCKS, parts):
            enc = ENCODERS[b]
            loc, L = self._head(p, enc, self._trunk(p, enc, x_t), True)
            zs.append(loc + torch.sum(L * e[..., None, :], -1))
            log_q = log_q + (
                torch.sum(-0.5 * e * e, -1) + e.shape[-1] * GAUSS
                - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                            -1))
        raw = zs[0]
        zx = torch.sigmoid(raw) * (self.ub - self.lb) + self.lb
        log_det = (torch.sum(raw - 2.0 * F.softplus(raw), -1)
                   + torch.sum(torch.log(torch.abs(self.ub - self.lb))))
        return zx, zs[1], zs[2], log_q - log_det

    def loss_comps(self, p, x, c, y, eps, lam):
        """The 8 per-datum ELBO components summed over the batch and
        divided as the logs divide them: (ELBO, KL_x, KL_c, KL_y, R_x, R_c,
        R_y, reg)."""
        cfg = self.cfg
        n = eps.shape[0]
        zx, zc, zy, log_q = self.encode(p, self._scale(0, x), eps)
        c_t, y_t = self._scale(1, c), self._scale(2, y)
        lp = self.prior_x_lp(zx)
        for b, z, a in (("c", zc, c_t), ("y", zy, y_t)):
            loc, L = self._head(p, f"prior_net_{b}",
                                self._trunk(p, f"prior_net_{b}", a), False)
            lp = lp + _mvn_lp(z, loc, L)
        kl_x = torch.mean(log_q - lp, 0)
        xh = self.physics(zx, c) + self.decoder_x(p, zc, zy, lam)
        sigma_x = torch.exp(p["log_sigma_x"])
        r_x = torch.sum(torch.sum(_normal_lp(x, xh, sigma_x), -1), 0) / n
        ch, ls_c = self.decoder_aux(p, "c", zc)
        yh, ls_y = self.decoder_aux(p, "y", zy)
        r_c = torch.sum(torch.sum(_normal_lp(c, ch, torch.exp(ls_c)), -1),
                        0) / n
        r_y = torch.sum(torch.sum(_normal_lp(y, yh, torch.exp(ls_y)), -1),
                        0) / n
        loss = (cfg["beta_x"] * kl_x - cfg["alpha_x"] * r_x
                - cfg["alpha_c"] * r_c - cfg["alpha_y"] * r_y)
        zero = torch.zeros_like(kl_x)
        rows = x.shape[0]
        div = torch.tensor([rows * (cfg["nd_x"] + cfg["nd_c"] + cfg["nd_y"])]
                           + [rows] * 7, dtype=torch.float32,
                           device=x.device)
        comps = torch.stack([loss, kl_x, zero, zero, r_x, r_c, r_y, zero])
        return torch.sum(comps, 1) / div


# ----------------------------------------------------------------------
# Training, drawn as the program draws them
# ----------------------------------------------------------------------

class Followed(NamedTuple):
    """``portbench/reference/dpivae.py``'s ``Followed``, and each leaf's
    first gradient whole (``grad0_full``), by which the comparison leaves
    out Adam's near-zero elements."""

    train: torch.Tensor
    val: torch.Tensor
    params: Dict[str, torch.Tensor]
    grad0: Dict[str, float]
    grad0_full: Dict[str, torch.Tensor]


def encoder_normals(cfg, generator, n: int, rows: int) -> torch.Tensor:
    """The x, c and y encoders' normals, drawn in turn, joined."""
    return torch.cat([torch.randn((n, rows, w), generator=generator,
                                  device=generator.device)
                      for w in widths(cfg)], -1)


def follow_training(cfg, reference: Reference, params, data_train, data_val,
                    generator: torch.Generator, n_steps: int,
                    lam: float) -> Followed:
    """``n_steps`` optimizer steps from ``params`` with the draws of
    ``generator`` (left where a member's training draws start)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = cfg["adam"]["betas"]
    eps_adam = cfg["adam"]["eps"]
    dev = generator.device
    rows, vals, grad0, grad0_full = [], [], {}, {}
    for step in range(n_steps):
        u = torch.rand((cfg["n_train"],), generator=generator, device=dev)
        idx = torch.topk(u, cfg["n_batch"]).indices
        eps = encoder_normals(cfg, generator, cfg["n_mc_train"],
                              cfg["n_batch"])
        batch = [a[idx] for a in data_train[:3]]
        comps = reference.loss_comps(p, *batch, eps, lam)
        grads = torch.autograd.grad(comps[0], list(p.values()))
        if step == 0:
            grad0_full = {k: g.detach().clone() for k, g in zip(p, grads)}
            grad0 = {k: float(torch.linalg.vector_norm(g.double()))
                     for k, g in zip(p, grads)}
        t = step + 1
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                w.sub_(ref._group_lr(cfg, k) * mh / (torch.sqrt(vh) + eps_adam))
            rows.append(torch.cat([comps.detach(),
                                   torch.exp(p["log_sigma_x"]).reshape(1)]))
        if step % cfg["val_freq"] == 0:
            eps_v = encoder_normals(cfg, generator, cfg["n_mc_val"],
                                    cfg["n_val"])
            with torch.no_grad():
                vals.append(reference.loss_comps(p, *data_val[:3], eps_v,
                                                 lam))
    return Followed(torch.stack(rows), torch.stack(vals),
                    {k: w.detach() for k, w in p.items()}, grad0, grad0_full)


def follow(cfg, part, weights, data_train, data_val, g, lam, n_steps,
           tf32=False) -> Followed:
    """The reference over ``n_steps`` steps (float32, or TF32)."""
    reference = Reference(cfg, data_train, g.device, part)
    with ref.matmul_precision(tf32):
        return follow_training(cfg, reference, weights, data_train, data_val,
                               g, n_steps, lam)

