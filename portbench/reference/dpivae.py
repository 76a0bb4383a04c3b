"""Plain PyTorch reference of the DPI-VAE S model, float32 with TF32 off.

Written from the published model (JanKoune/DPI-VAE, arXiv:2506.13658) and
the sizes in a configuration file of ``portbench/configs``: the joint
full-covariance encoder with the logistic squash of z_x into the prior's
box, the learned diagonal priors of z_c and z_y, the physics decoder plus
the gradient-reversed data branch, the Gaussian c and y decoders, the
Monte-Carlo ELBO, grouped Adam, and the MC-posterior means a predictor
serves. It imports nothing of the program under test: every leaf, scaler,
draw and constant is worked out here from the configuration, the data
and a seeded generator.

The random draws follow the program's documented protocol (batch rows as
the top ``n_batch`` of ``n_train`` uniforms, then the encoder's normals,
one validation draw after each block's first step), so that both sides
see the same inputs.

Every matrix product is ``F.linear``: the MVN algebra (d <= 16) is written
elementwise, so ``torch.utils.flop_counter`` counts the linear layers
alone, as ``portbench/work/counts.py`` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

GAUSS = -0.5 * math.log(2.0 * math.pi)
JITTER = 1e-8


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in full precision (``tf32=False``) or in TF32, the
    control's precision; the flags are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def nz(cfg) -> int:
    return cfg["nz_x"] + cfg["nz_c"] + cfg["nz_y"]


def leaves(cfg) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every parameter, in the order a model is
    initialised: encoder, the two priors, decoder_x, decoder_c, decoder_y,
    log_sigma_x (fan_in 0: it starts at zero)."""
    H, P, A = (cfg["encoder_hidden"], cfg["prior_hidden"],
               cfg["decoder_aux_hidden"])
    D, n = cfg["decoder_x_hidden"], nz(cfg)

    def lin(prefix, fan_in, fan_out):
        return [(f"{prefix}.weight", (fan_out, fan_in), fan_in),
                (f"{prefix}.bias", (fan_out,), fan_in)]

    out = (lin("encoder.trunk.layers.0", cfg["nd_x"], H)
           + lin("encoder.f_mean", H, n) + lin("encoder.f_sigma", H, n)
           + lin("encoder.f_cov", H, n * n))
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


def bulk_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Weights from one draw of uniforms on the generator's device:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias, and
    log_sigma_x 0."""
    spec = leaves(cfg)
    sizes = [math.prod(s) for _, s, _ in spec]
    u = torch.rand(sum(sizes), generator=generator, device=generator.device)
    out = {}
    for (name, shape, fan_in), part in zip(spec, torch.split(u, sizes)):
        out[name] = (torch.zeros(shape, device=u.device) if fan_in == 0
                     else ((2.0 * part - 1.0) / math.sqrt(fan_in)).reshape(shape))
    return out


def seeded_init(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The weights a sweep member starts from: each weight, then its bias,
    drawn as U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from the member's
    generator, one draw per leaf in initialisation order."""
    out = {}
    for name, shape, fan_in in leaves(cfg):
        if fan_in == 0:
            out[name] = torch.zeros(shape, device=generator.device)
            continue
        u = torch.rand(shape, generator=generator, device=generator.device)
        out[name] = (2.0 * u - 1.0) * (1.0 / math.sqrt(fan_in))
    return out


def member_seed(seed: int, member: int) -> int:
    """The seed of a sweep member's generator, from the sweep seed and the
    member's index (numpy's SeedSequence, two 32-bit words)."""
    import numpy as np

    state = np.random.SeedSequence([int(seed), int(member)]).generate_state(
        2, dtype=np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


# ----------------------------------------------------------------------
# Data
# ----------------------------------------------------------------------

def surrogate(arrays: Dict[str, torch.Tensor], z: torch.Tensor):
    """The case's frozen tanh MLP from its archive's arrays (w: (in, out))."""
    h = (z - arrays["scaler_mean"]) / arrays["scaler_scale"]
    n = sum(1 for k in arrays if k.startswith("w"))
    for i in range(n):
        h = h @ arrays[f"w{i}"] + arrays[f"b{i}"]
        if i < n - 1:
            h = torch.tanh(h)
    return h


def sample_response(cfg, arrays, generator: torch.Generator, n: int):
    """(x, c, y): factors uniform over the configuration's ground-truth
    boxes (one draw per factor), the response from the surrogate plus
    noise, then the c and y factors plus noise."""
    dev = generator.device
    z = torch.stack([
        f["low"] + (f["high"] - f["low"]) * torch.rand(
            (n,), generator=generator, device=dev)
        for f in cfg["factors"]], dim=-1)
    x = surrogate(arrays, z)
    x = x + cfg["sigma_x"] * torch.randn(x.shape, generator=generator,
                                         device=dev)
    out = [x]
    for b in "cy":
        cols = [i for i, f in enumerate(cfg["factors"]) if f["type"] == b]
        v = z[:, cols[0]:cols[-1] + 1]
        out.append(v + cfg[f"sigma_{b}"] * torch.randn(
            v.shape, generator=generator, device=dev))
    return tuple(out)


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def _normal_lp(x, loc, scale):
    zn = (x - loc) / scale
    return -0.5 * zn * zn + GAUSS - torch.log(scale)


def _tril_solve(L, b):
    d = b.shape[-1]
    xs = []
    for i in range(d):
        s = b[..., i]
        for j in range(i):
            s = s - L[..., i, j] * xs[j]
        xs.append(s / L[..., i, i])
    return torch.stack(xs, dim=-1)


def _mvn_lp(z, loc, L):
    u = _tril_solve(L, z - loc)
    logdiag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    return (torch.sum(-0.5 * u * u, -1) + z.shape[-1] * GAUSS
            - torch.sum(logdiag, -1))


class Reference:
    """The S model over a state dict ``p`` of ``leaves(cfg)``, with the
    input scalers fitted on ``data_train`` (population std)."""

    def __init__(self, cfg, data_train, device):
        self.cfg = cfg
        self.device = device
        self.scalers = [(a.mean(0, keepdim=True),
                         a.std(0, keepdim=True, correction=0))
                        for a in data_train[:3]]
        px = cfg["prior_x"]
        self.lb = torch.tensor([d["lb"] for d in px], device=device)
        self.ub = torch.tensor([d["ub"] for d in px], device=device)
        phys = cfg["physics"]
        if phys["kind"] == "beam_point_load":
            self.grid = torch.linspace(0.0, phys["L"], cfg["nd_x"],
                                       device=device)
        else:
            self.grid = torch.linspace(phys["t_min"], phys["t_max"],
                                       cfg["nd_x"], dtype=torch.float64,
                                       device=device).float()

    # -- pieces --------------------------------------------------------
    def _scale(self, i, a):
        mean, std = self.scalers[i]
        return (a - mean) / std

    def _head(self, p, prefix, h, full):
        loc = torch.clamp(F.linear(h, p[f"{prefix}.f_mean.weight"],
                                   p[f"{prefix}.f_mean.bias"]), -50.0, 50.0)
        sigma = torch.exp(torch.clamp(F.linear(
            h, p[f"{prefix}.f_sigma.weight"], p[f"{prefix}.f_sigma.bias"]),
            -7.0, 3.0))
        L = torch.diag_embed(sigma + JITTER)
        if full:
            d = loc.shape[-1]
            off = torch.clamp(F.linear(h, p[f"{prefix}.f_cov.weight"],
                                       p[f"{prefix}.f_cov.bias"]), -20.0, 20.0)
            L = L + torch.tril(off.reshape(*h.shape[:-1], d, d), diagonal=-1)
        return loc, L

    def _trunk(self, p, prefix, a):
        return F.relu(F.linear(a, p[f"{prefix}.trunk.layers.0.weight"],
                               p[f"{prefix}.trunk.layers.0.bias"]))

    def prior_x_lp(self, zx):
        out = []
        for i, d in enumerate(self.cfg["prior_x"]):
            z = zx[..., i]
            if d["dist"] == "normal":
                zn = (z - d["loc"]) / d["scale"]
                out.append(-0.5 * zn * zn + GAUSS - math.log(d["scale"]))
            else:
                inside = (z >= d["low"]) & (z <= d["high"])
                out.append(torch.where(inside, -math.log(d["high"] - d["low"]),
                                       -math.inf))
        return torch.stack(out, -1).sum(-1)

    def physics(self, zx):
        phys = self.cfg["physics"]
        if phys["kind"] == "beam_point_load":
            x, L, I, P = self.grid, phys["L"], phys["I"], phys["P"]
            E = zx[..., 0:1] * 1e6
            a = zx[..., 1:2]
            b = L - a
            w = P * b * x * (L ** 2 - b ** 2 - x ** 2) / (6.0 * E * I * L)
            w = torch.where(x > a, w + P * (x - a) ** 3 / (6.0 * E * I), w)
            return -1000.0 * w
        omega = torch.sqrt(1.0 / zx[..., 0:1])
        return torch.cos(omega * self.grid)

    def encode(self, p, x_t, eps):
        """(zx, zc, zy, log q) for encoder normals ``eps`` (n, b, nz)."""
        cfg = self.cfg
        loc, L = self._head(p, "encoder", self._trunk(p, "encoder", x_t),
                            True)
        z = loc + torch.sum(L * eps[..., None, :], -1)
        log_q = (torch.sum(-0.5 * eps * eps, -1) + eps.shape[-1] * GAUSS
                 - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             -1))
        nx, nc = cfg["nz_x"], cfg["nz_c"]
        raw = z[..., :nx]
        zx = torch.sigmoid(raw) * (self.ub - self.lb) + self.lb
        log_det = (torch.sum(raw - 2.0 * F.softplus(raw), -1)
                   + torch.sum(torch.log(torch.abs(self.ub - self.lb))))
        return zx, z[..., nx:nx + nc], z[..., nx + nc:], log_q - log_det

    def decoder_x(self, p, zc, zy, alpha):
        z = torch.cat((zc, zy), -1)
        if alpha is not None and torch.is_grad_enabled():
            z = _Reverse.apply(z, alpha)
        h = F.relu(F.linear(z, p["decoder_x.fx0.weight"],
                            p["decoder_x.fx0.bias"]))
        return F.linear(h, p["decoder_x.fx1.weight"], p["decoder_x.fx1.bias"])

    def decoder_aux(self, p, b, z):
        h = F.relu(F.linear(z, p[f"decoder_{b}.layers.0.weight"],
                            p[f"decoder_{b}.layers.0.bias"]))
        out = F.linear(h, p[f"decoder_{b}.layers.1.weight"],
                       p[f"decoder_{b}.layers.1.bias"])
        nd = self.cfg[f"nd_{b}"]
        return out[..., :nd], out[..., nd:]

    # -- the loss --------------------------------------------------------
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
        xh = self.physics(zx) + self.decoder_x(p, zc, zy, lam)
        sigma_x = torch.exp(p["log_sigma_x"])
        r_x = torch.sum(torch.sum(_normal_lp(x, xh, sigma_x), -1), 0) / n
        ch, ls_c = self.decoder_aux(p, "c", zc)
        yh, ls_y = self.decoder_aux(p, "y", zy)
        r_c = torch.sum(torch.sum(_normal_lp(c, ch, torch.exp(ls_c)), -1), 0) / n
        r_y = torch.sum(torch.sum(_normal_lp(y, yh, torch.exp(ls_y)), -1), 0) / n
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

def _group_lr(cfg, name: str) -> float:
    lr = cfg["adam"]["lr"]
    if name == "log_sigma_x":
        return lr["log_sigma_x"]
    return lr[name.split(".", 1)[0]]


class Followed(NamedTuple):
    """What ``follow_training`` gives: train rows (n_steps, 9), the
    components of each step's loss and sigma_x after the step; validation
    rows (blocks, 8), each after its block's first step; every leaf after
    the last step; and the norm of each leaf's first gradient (float64)."""

    train: torch.Tensor
    val: torch.Tensor
    params: Dict[str, torch.Tensor]
    grad0: Dict[str, float]


def follow_training(cfg, ref: Reference, params, data_train, data_val,
                    generator: torch.Generator, n_steps: int,
                    lam: float) -> Followed:
    """``n_steps`` optimizer steps from ``params`` with the draws of
    ``generator``."""
    dev = generator.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = cfg["adam"]["betas"]
    eps_adam = cfg["adam"]["eps"]
    width = nz(cfg)
    rows, vals, grad0 = [], [], {}
    for step in range(n_steps):
        u = torch.rand((cfg["n_train"],), generator=generator, device=dev)
        idx = torch.topk(u, cfg["n_batch"]).indices
        eps = torch.randn((cfg["n_mc_train"], cfg["n_batch"], width),
                          generator=generator, device=dev)
        batch = [a[idx] for a in data_train[:3]]
        comps = ref.loss_comps(p, *batch, eps, lam)
        grads = torch.autograd.grad(comps[0], list(p.values()))
        if step == 0:
            grad0 = {k: float(torch.linalg.vector_norm(g.double()))
                     for k, g in zip(p, grads)}
        t = step + 1
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                w.sub_(_group_lr(cfg, k) * mh / (torch.sqrt(vh) + eps_adam))
            rows.append(torch.cat([comps.detach(),
                                   torch.exp(p["log_sigma_x"]).reshape(1)]))
        if step % cfg["val_freq"] == 0:
            eps_v = torch.randn((cfg["n_mc_val"], cfg["n_val"], width),
                                generator=generator, device=dev)
            with torch.no_grad():
                vals.append(ref.loss_comps(p, *data_val[:3], eps_v, lam))
    return Followed(torch.stack(rows), torch.stack(vals),
                    {k: w.detach() for k, w in p.items()}, grad0)
