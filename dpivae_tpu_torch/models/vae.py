"""DPIVAE: the physics-informed adversarially-disentangled VAE (counterpart
of dpivae_tpu/models/vae.py:33-35,110-478).

``DPIVAE`` is a static configuration object, as in the JAX package; the
trainable state is a ``DPIVAEParams`` module with one submodule per
optimizer group::

    encoder, [encoder_c, encoder_y],      # S: one; P: three
    prior_net_c, prior_net_y, decoder_x, decoder_c, decoder_y,
    log_sigma_x

Randomness is explicit: ``sample``/``forward``/``encode`` take a
``torch.Generator``, or a ``noise`` mapping of ready-made standard normals
(the seam through which tests hand in the JAX package's exact draws).

Both models are ported, S (one joint encoder) and P (three per-block
encoders over the same x), each with the dense or the Conv1d encoder
trunk, for sampling and for the training loss (with the MC-chunked form
of ``mc_chunk``), and with the decode's two options: ``remat_decode``
(the decode recomputed in the backward, ``ops.remat.recompute``, which
composes with the sweeps' ``torch.func`` transforms) and
``compute_dtype="bfloat16"`` (the decode's MLPs and physics in bf16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Collection, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from dpivae_tpu_torch.models.decoders import (
    DECODER_X_HIDDEN,
    GaussianDecoder,
    GradRevAdditiveDecoder,
)
from dpivae_tpu_torch.models.encoders import (
    CNNEncoder,
    FactorizedNN,
    FullCovNN,
    gaussian_encoder_sample,
)
from dpivae_tpu_torch.ops import latent
from dpivae_tpu_torch.ops.mvn import mvn_log_prob
from dpivae_tpu_torch.ops.remat import recompute
from dpivae_tpu_torch.utils import (
    GAUSSIAN_CONST,
    DeviceLike,
    draw_normals,
    resolve_device,
    spans,
)
from dpivae_tpu_torch.utils.distributions import MarginalDistribution

Noise = Optional[Mapping[str, torch.Tensor]]

# The decode's outputs by the name ``parts`` selects them with.
DECODE_PARTS = ("xh_p", "xh_d", "c", "y")
# The decode outputs each slot of ``sample``'s 9-tuple reads.
_SLOT_PARTS = {0: ("xh_p", "xh_d"), 1: ("xh_p",), 2: ("xh_d",), 3: ("c",),
               4: ("y",)}
# The part each output of the decode's 6-tuple belongs to.
_OUTPUT_PARTS = ("xh_p", "xh_d", "c", "c", "y", "y")
_DECODERS = ("decoder_x", "decoder_c", "decoder_y")
_COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}
# (slot, noise name, model width) of ``sample``'s observation noise, in
# the order it is drawn.
OBSERVATION_NOISE = ((0, "x", "nd_x"), (3, "c", "nd_c"), (4, "y", "nd_y"))


def _normal_log_prob(x, loc, scale):
    """Elementwise Gaussian log density; ``scale`` a tensor or a float."""
    zn = (x - loc) / scale
    log_scale = (torch.log(scale) if isinstance(scale, torch.Tensor)
                 else math.log(scale))
    return -0.5 * zn * zn + GAUSSIAN_CONST - log_scale


def _mc_sum(log_prob):
    """Sum over the last (data) axis, then over the leading MC axis."""
    return torch.sum(torch.sum(log_prob, dim=-1), dim=0)


def _normal(noise: Noise, name: str, shape, like: torch.Tensor):
    """``noise[name]``, checked to have ``shape``, on ``like``'s device and
    dtype."""
    eps = noise[name]
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(
            f"noise[{name!r}] has shape {tuple(eps.shape)}, expected "
            f"{tuple(shape)}"
        )
    return eps.to(device=like.device, dtype=like.dtype)


class DPIVAEParams(nn.Module):
    """The trainable state of a DPIVAE, one submodule per optimizer group;
    ``encoder_c`` and ``encoder_y`` exist in the P model only."""

    def __init__(self, encoder: nn.Module, prior_net_c: nn.Module,
                 prior_net_y: nn.Module, decoder_x: GradRevAdditiveDecoder,
                 decoder_c: GaussianDecoder, decoder_y: GaussianDecoder,
                 log_sigma_x: torch.Tensor,
                 encoder_c: Optional[nn.Module] = None,
                 encoder_y: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        if encoder_c is not None:
            self.encoder_c = encoder_c
            self.encoder_y = encoder_y
        self.prior_net_c = prior_net_c
        self.prior_net_y = prior_net_y
        self.decoder_x = decoder_x
        self.decoder_c = decoder_c
        self.decoder_y = decoder_y
        # Learned global observation-noise scalar
        self.log_sigma_x = nn.Parameter(log_sigma_x)


class _BoundParams(nn.Module):
    """``DPIVAEParams`` as a submodule, so that ``functional_call`` can put
    a member's tensors in its place for one method of the static
    ``DPIVAE``."""

    def __init__(self, params: DPIVAEParams):
        super().__init__()
        self.params = params

    def forward(self, model, method, *args, **kwargs):
        return getattr(model, method)(self.params, *args, **kwargs)


def bind_params(model: "DPIVAE"):
    """A ``call(model, method, state, *args, **kwargs)`` that runs
    ``getattr(model, method)(params, *args, **kwargs)`` with ``params``
    holding the tensors of ``state``, a ``DPIVAEParams`` state dict,
    through ``torch.func.functional_call``. That is how the member-batched
    paths run this single-member model code on each member's tensors under
    ``torch.func.vmap``. ``model`` gives the params' structure (an
    initialized copy on the meta device)."""
    structure = _BoundParams(
        model.init(torch.Generator(), device="cpu").to("meta"))

    def call(model, method, state, *args, **kwargs):
        return functional_call(
            structure, {f"params.{k}": v for k, v in state.items()},
            (model, method, *args), kwargs)

    return call


@dataclasses.dataclass
class DPIVAE:
    """Static model configuration: dims, architecture, the fixed z_x prior
    ``prior_x``, the frozen ``physics_model``, and the fitted input scalers
    and z_x squash built by ``train.setup.setup_model``."""

    prior_x: MarginalDistribution
    physics_model: Callable[[torch.Tensor], torch.Tensor]
    nz_x: int
    nz_c: int
    nz_y: int
    nd_x: int
    nd_c: int
    nd_y: int
    idx_c_phys: Tuple[int, ...]
    model_type: str = "S"  # "P" | "S"
    full_cov_prior: bool = False
    lambda_x: Optional[float] = None
    encoder_layers: Tuple[int, ...] = (64,)  # P-mode per-block encoders
    encoder_layers_s: Tuple[int, ...] = (128,)  # S-mode joint encoder
    # Encoder trunks: "NN" (dense) or "CNN" (Conv1d over the signal)
    encoder_x_arch: str = "NN"
    encoder_c_arch: str = "NN"
    encoder_y_arch: str = "NN"
    ch_in: int = 1
    ch_out: int = 16
    ch_latent: int = 64
    prior_net_layers: Tuple[int, ...] = (64,)
    decoder_aux_layers: Tuple[int, ...] = (64,)
    decoder_x_hidden: int = DECODER_X_HIDDEN
    transform_x: Optional[object] = None
    transform_c: Optional[object] = None
    transform_y: Optional[object] = None
    output_transform_zx: Optional[object] = None  # squash for z_x
    # Run decoder_x's data-driven branch through the fused-MLP kernel
    use_pallas: bool = False
    # The decode's dtype: None (f32) or "bfloat16", for the decoder MLPs
    # and the physics; the encoder, the MVN algebra, the reductions and
    # the stored params stay f32, and the decode's outputs return to f32.
    compute_dtype: Optional[str] = None
    # Recompute the decode in the backward instead of keeping its
    # activations (ops.remat.recompute)
    remat_decode: bool = False
    # MC chunking of the training loss's decode; sampling ignores it
    mc_chunk: Optional[int] = None

    def __post_init__(self):
        if self.model_type not in ("P", "S"):
            raise ValueError(f"Invalid model_type {self.model_type}")
        for which in ("x", "c", "y"):
            arch = getattr(self, f"encoder_{which}_arch")
            if arch not in ("NN", "CNN"):
                raise ValueError(f"Unknown encoder_{which} choice: {arch}")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be None or 'bfloat16', got "
                f"{self.compute_dtype!r}")

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> DPIVAEParams:
        """Build the params, drawn from ``generator``, on ``device`` (None
        means CUDA)."""
        device = resolve_device(device)
        prior_cls = FullCovNN if self.full_cov_prior else FactorizedNN

        def encoder(arch, n_latent, layers):
            if arch == "CNN":
                return CNNEncoder(n_latent, self.nd_x, generator, device,
                                  ch_in=self.ch_in, ch_out=self.ch_out,
                                  ch_latent=self.ch_latent)
            return FullCovNN(n_latent, self.nd_x, layers, generator, device)

        if self.model_type == "S":
            nz = self.nz_x + self.nz_c + self.nz_y
            encoders = dict(encoder=encoder(self.encoder_x_arch, nz,
                                            self.encoder_layers_s))
        else:  # "P": three per-block encoders over the same x
            encoders = dict(
                encoder=encoder(self.encoder_x_arch, self.nz_x,
                                self.encoder_layers),
                encoder_c=encoder(self.encoder_c_arch, self.nz_c,
                                  self.encoder_layers),
                encoder_y=encoder(self.encoder_y_arch, self.nz_y,
                                  self.encoder_layers),
            )
        return DPIVAEParams(
            **encoders,
            prior_net_c=prior_cls(self.nz_c, self.nd_c, self.prior_net_layers,
                                  generator, device),
            prior_net_y=prior_cls(self.nz_y, self.nd_y, self.prior_net_layers,
                                  generator, device),
            decoder_x=GradRevAdditiveDecoder(
                self.nz_c + self.nz_y, self.nd_x, generator, device,
                hidden=self.decoder_x_hidden,
            ),
            decoder_c=GaussianDecoder(self.nz_c, self.nd_c,
                                      self.decoder_aux_layers, generator, device),
            decoder_y=GaussianDecoder(self.nz_y, self.nd_y,
                                      self.decoder_aux_layers, generator, device),
            log_sigma_x=torch.zeros((), device=device),
        )

    # ------------------------------------------------------------------
    # Forward components
    # ------------------------------------------------------------------
    def transform_inputs(self, x=None, c=None, y=None):
        """Standardize the provided modalities."""
        x_t = c_t = y_t = None
        if x is not None:
            x_t = self.transform_x.forward(x)[0] if self.transform_x else x
        if c is not None:
            c_t = self.transform_c.forward(c)[0] if self.transform_c else c
        if y is not None:
            y_t = self.transform_y.forward(y)[0] if self.transform_y else y
        return x_t, c_t, y_t

    def prior_net(self, params: DPIVAEParams, c, y=None):
        """Learned conditional priors p(z_c|c), p(z_y|y) on transformed
        inputs: (loc_c, tril_c, loc_y, tril_y), the y pair None without y."""
        _, c_t, y_t = self.transform_inputs(c=c, y=y)
        loc_c, tril_c = params.prior_net_c(c_t)
        if y is None:
            return loc_c, tril_c, None, None
        loc_y, tril_y = params.prior_net_y(y_t)
        return loc_c, tril_c, loc_y, tril_y

    def sample_prior(self, params: DPIVAEParams, c, y, n: int = 1, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Noise = None, device: DeviceLike = None):
        """Sample z_c ~ p(z_c|c) and z_y ~ p(z_y|y) from the learned priors:
        (zc, log p(zc|c), zy, log p(zy|y)), zc and zy of shape
        (n, batch, nz_*).

        ``c`` and ``y`` (arrays or tensors) are placed on ``device`` (None
        means CUDA), where the params must be. Randomness comes from
        ``generator``, which draws "z_c" then "z_y", or from ``noise``, a
        mapping of those two names to standard normals of shape
        (n, batch, nz_*).
        """
        device = resolve_device(device)
        c = torch.as_tensor(c, dtype=torch.float32, device=device)
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
        lead = (n, *c.shape[:-1])
        if noise is None:
            noise = draw_normals((("z_c", self.nz_c), ("z_y", self.nz_y)),
                                 generator, lead, device)
        loc_c, tril_c, loc_y, tril_y = self.prior_net(params, c, y=y)
        zc, dens_zc = gaussian_encoder_sample(
            loc_c, tril_c, n,
            eps=_normal(noise, "z_c", (*lead, self.nz_c), loc_c))
        zy, dens_zy = gaussian_encoder_sample(
            loc_y, tril_y, n,
            eps=_normal(noise, "z_y", (*lead, self.nz_y), loc_y))
        return zc, dens_zc, zy, dens_zy

    def noise_draws(self, cond: bool = False,
                    observations: bool = True) -> Tuple[Tuple[str, int], ...]:
        """What the model draws from a generator, in order, as (noise name,
        width), each draw (n, batch, width): the encoder's one joint draw
        (S) or the x, c and y encoders' draws in turn (P), all "z";
        "z_prior" with ``cond``; with ``observations``, ``sample``'s
        observation noise "x", "c", "y" of every slot. ``draw_normals``
        draws them; a ``noise`` mapping of the same names reproduces a
        generator's draws."""
        z = ((self.nz_x + self.nz_c + self.nz_y,) if self.model_type == "S"
             else (self.nz_x, self.nz_c, self.nz_y))
        return (tuple(("z", w) for w in z)
                + ((("z_prior", self.nz_c),) if cond else ())
                + (tuple((name, getattr(self, width))
                         for _, name, width in OBSERVATION_NOISE)
                   if observations else ()))

    def encode(self, params: DPIVAEParams, x, n: int = 1, *,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None):
        """Sample latents from q(z|x). Returns (zx, zc, zy, log q).

        S: one joint encoder, the squash on the z_x slice, split by dims.
        P: three encoders over the same x, the squash on z_x only, and the
        three log-densities summed. ``eps`` is (n, batch, nz_x + nz_c +
        nz_y) for both: for P its slices are the x, c and y encoders'
        standard normals, in that order, as the JAX package splits its key.
        """
        nz_x, nz_c = self.nz_x, self.nz_c
        if eps is None:
            eps = draw_normals(self.noise_draws(observations=False),
                               generator, (n, *x.shape[:-1]), x.device)["z"]
        if self.model_type == "S":
            loc, tril = params.encoder(x)
            z, dens_z = gaussian_encoder_sample(
                loc, tril, n, eps=eps,
                output_transform=self.output_transform_zx,
            )
            return (z[..., :nz_x], z[..., nz_x: nz_x + nz_c],
                    z[..., nz_x + nz_c:], dens_z)
        eps_x, eps_c, eps_y = torch.split(eps, [nz_x, nz_c, self.nz_y],
                                          dim=-1)
        zx, dens_zx = gaussian_encoder_sample(
            *params.encoder(x), n, eps=eps_x,
            output_transform=self.output_transform_zx,
        )
        zc, dens_zc = gaussian_encoder_sample(*params.encoder_c(x), n,
                                              eps=eps_c)
        zy, dens_zy = gaussian_encoder_sample(*params.encoder_y(x), n,
                                              eps=eps_y)
        return zx, zc, zy, dens_zx + dens_zc + dens_zy

    def decode(self, params: DPIVAEParams, zx_in, zc, zy, grl_alpha=None,
               parts: Collection[str] = DECODE_PARTS):
        """(xh_p, xh_d, c_hat, log_sigma_c, y_hat, log_sigma_y), computing
        only the outputs named in ``parts`` (a subset of DECODE_PARTS; "c"
        and "y" each name a pair) and None in the others' places.

        With ``remat_decode`` the decode is one recompute region
        (``ops.remat.recompute``, over the latents and the decoders'
        parameters): the backward recomputes its activations from them, so
        with the kernel on a train step launches the forward kernel twice.
        It composes with ``torch.func.vmap(grad(...))``, so the sweeps run
        it member-batched. The decode draws no random numbers, so no RNG
        state is kept for the recompute.
        """
        if not self.remat_decode:
            return self._decode_impl(params, zx_in, zc, zy, grl_alpha, parts)
        keep = [i for i, p in enumerate(_OUTPUT_PARTS) if p in parts]
        names, weights = zip(*(
            (f"params.{d}.{k}", w) for d in _DECODERS
            for k, w in getattr(params, d).named_parameters()))
        bound = _BoundParams(params)
        # A tensor strength (a sweep member's) enters as a constant input.
        consts = (grl_alpha,) if isinstance(grl_alpha, torch.Tensor) else ()

        def run(zx_in, zc, zy, *rest):
            alpha = rest[len(names)] if consts else grl_alpha
            out = functional_call(
                bound, dict(zip(names, rest[:len(names)])),
                (self, "_decode_impl", zx_in, zc, zy, alpha, parts))
            return tuple(out[i] for i in keep)

        computed = recompute(run, (zx_in, zc, zy, *weights), consts)
        out = [None] * len(_OUTPUT_PARTS)
        for i, t in zip(keep, computed):
            out[i] = t
        return tuple(out)

    def _decode_impl(self, params: DPIVAEParams, zx_in, zc, zy, grl_alpha,
                     parts):
        """The decode. With ``compute_dtype`` the latents and the decoder
        weights (cast on the way in, through ``functional_call``: the
        stored parameters stay f32 and take f32 gradients) run in that
        dtype, and every output returns to f32."""
        dt = _COMPUTE_DTYPES[self.compute_dtype]

        def run(module, *args, **kwargs):
            if dt is None:
                return module(*args, **kwargs)
            weights = {name: p.to(dt) for name, p in module.named_parameters()}
            return functional_call(module, weights, args, kwargs)

        if dt is not None:
            zx_in, zc, zy = zx_in.to(dt), zc.to(dt), zy.to(dt)
        xh_d = xh_p = ch = log_sigma_c = yh = log_sigma_y = None
        if "xh_d" in parts:
            xh_d = run(params.decoder_x, torch.cat((zc, zy), dim=-1),
                       grl_alpha=grl_alpha, use_pallas=self.use_pallas)
        if "xh_p" in parts:
            xh_p = self.physics_model(zx_in)
        if "y" in parts:
            yh, log_sigma_y = run(params.decoder_y, zy)
        if "c" in parts:
            ch, log_sigma_c = run(params.decoder_c, zc)
        out = (xh_p, xh_d, ch, log_sigma_c, yh, log_sigma_y)
        if dt is not None:
            out = tuple(None if a is None else a.float() for a in out)
        return out

    def _encode_latents(self, params: DPIVAEParams, x, c, cond: bool, n: int,
                        *, generator=None, noise: Noise = None):
        """Encode half of ``forward``: latents, their density, and the
        decoder_x input with the physical covariates concatenated."""
        x_t, c_t, _ = self.transform_inputs(x=x, c=c)
        if noise is None:
            noise = draw_normals(self.noise_draws(cond, observations=False),
                                 generator, (n, *x.shape[:-1]), x.device)
        zx, zc, zy, dens_z = self.encode(params, x_t, n=n, eps=noise["z"])

        if cond:
            loc_c, tril_c = params.prior_net_c(c_t)
            zc, _ = gaussian_encoder_sample(loc_c, tril_c, n,
                                            eps=noise["z_prior"])

        return zx, zc, zy, dens_z, self._decoder_x_input(zx, c, n)

    def _decoder_x_input(self, zx, c, n: int):
        """z_x with the raw physical covariates concatenated, tiled over the
        MC axis; idx_c_phys == () means z_x itself. The columns are stacked
        from views: indexing with a list would copy an index tensor from
        the host on every call, which a CUDA graph cannot capture."""
        if not self.idx_c_phys:
            return zx
        c_phys = torch.stack([c[..., i] for i in self.idx_c_phys], dim=-1)
        c_phys = c_phys.expand(n, *c_phys.shape)
        return torch.cat((zx, c_phys), dim=-1)

    def forward(self, params: DPIVAEParams, x, c, cond: bool = False,
                n: int = 1, grl_alpha=None, *, generator=None,
                noise: Noise = None):
        """Full forward pass: (xh_p, xh_d, c_hat, log_sigma_c, y_hat,
        log_sigma_y, zx, zc, zy, log q)."""
        zx, zc, zy, dens_z, zx_in = self._encode_latents(
            params, x, c, cond, n, generator=generator, noise=noise
        )
        xh_p, xh_d, ch, log_sigma_c, yh, log_sigma_y = self.decode(
            params, zx_in, zc, zy, grl_alpha=grl_alpha
        )
        return xh_p, xh_d, ch, log_sigma_c, yh, log_sigma_y, zx, zc, zy, dens_z

    # ------------------------------------------------------------------
    # Loss and sampling
    # ------------------------------------------------------------------
    def loss(self, params: DPIVAEParams, x, c, y, n: int = 1, beta_x=1.0,
             beta_c=1.0, beta_y=1.0, alpha_x=1.0, alpha_c=1.0, alpha_y=1.0,
             grl_alpha=None, *, generator=None, noise: Noise = None):
        """Per-datapoint Monte-Carlo ELBO.

        Returns the 8-tuple (loss, KL_x, KL_c, KL_y, R_x, R_c, R_y, reg),
        each of shape (batch,). Randomness comes from ``generator`` or from
        ``noise={"z": (n, batch, nz)}``, the encoder's standard normals.

        With ``mc_chunk`` set (and < n) the decode and the reconstruction
        terms run over n/mc_chunk equal MC chunks, summed and divided by n
        at the end: the same MC means up to summation order. n must be a
        multiple of mc_chunk.

        The S model's latent algebra (the encoder sample, the squash, the
        three priors' densities and KL_x) runs as one op,
        ``ops.latent.latent_gauss`` (``_latents_s``): its CUDA kernels on
        the card, its plain version on the CPU and under ``torch.func``
        transforms. The P model's (three encoder samples and densities)
        runs in plain PyTorch. Each composition the loss runs in plain
        PyTorch in place of the kernels counts ``latent.plain``
        (``utils/spans.py``).
        """
        mc = self.mc_chunk if self.mc_chunk is not None and self.mc_chunk < n else n
        if n % mc:
            raise ValueError(
                f"mc_chunk={self.mc_chunk} must divide the MC sample "
                f"count n={n} (equal chunks keep the MC mean exact)"
            )
        if self.model_type == "S":
            zx, zc, zy, KL_x = self._latents_s(params, x, c, y, n,
                                               generator, noise)
            zx_in = self._decoder_x_input(zx, c, n)
        else:
            spans.count("latent.plain", model_type="P")
            zx, zc, zy, dens_z, zx_in = self._encode_latents(
                params, x, c, False, n, generator=generator, noise=noise
            )

            # The P model's priors: fixed marginal on z_x, learned full-cov
            # Gaussians on z_c, z_y
            loc_c, tril_c, loc_y, tril_y = self.prior_net(params, c, y=y)
            log_prior_zx = torch.sum(self.prior_x.log_prob(zx), dim=-1)
            log_prior_zc = mvn_log_prob(zc, loc_c, tril_c)
            log_prior_zy = mvn_log_prob(zy, loc_y, tril_y)
            log_prior_z = log_prior_zx + log_prior_zc + log_prior_zy

            # Joint-latent MC KL estimate
            KL_x = torch.mean(dens_z - log_prior_z, dim=0)
        KL_c = torch.zeros_like(KL_x)
        KL_y = torch.zeros_like(KL_x)

        # Gaussian reconstruction log-likelihoods, summed over MC chunks
        sigma_x = torch.exp(params.log_sigma_x)
        sums = None
        for start in range(0, n, mc):
            chunk = slice(start, start + mc)
            xh_p, xh_d, ch, log_sigma_c, yh, log_sigma_y = self.decode(
                params, zx_in[chunk], zc[chunk], zy[chunk], grl_alpha=grl_alpha
            )
            terms = [
                _mc_sum(_normal_log_prob(x, xh_p + xh_d, sigma_x)),
                _mc_sum(_normal_log_prob(c, ch, torch.exp(log_sigma_c))),
                _mc_sum(_normal_log_prob(y, yh, torch.exp(log_sigma_y))),
            ]
            # Optional magnitude penalty on the data-driven branch
            if self.lambda_x is not None:
                terms.append(_mc_sum(_normal_log_prob(xh_d, 0.0, self.lambda_x)))
            sums = terms if sums is None else [
                a + b for a, b in zip(sums, terms)]
        R_x, R_c, R_y = (s / n for s in sums[:3])
        reg = sums[3] / n if self.lambda_x is not None else torch.zeros_like(KL_x)

        loss = beta_x * KL_x - alpha_x * R_x - alpha_c * R_c - alpha_y * R_y - reg
        return loss, KL_x, KL_c, KL_y, R_x, R_c, R_y, reg

    def _latents_s(self, params: DPIVAEParams, x, c, y, n: int,
                   generator, noise: Noise):
        """The S model's (zx, zc, zy, KL_x) from its three heads' raw
        outputs, through ``ops.latent.latent_gauss``. Where a
        ``torch.func`` transform wraps the tensors (the sweeps'
        ``vmap(grad(...))``) or a trace runs, through its plain version
        ``latent_gauss_reference``, which the transforms take."""
        x_t, c_t, y_t = self.transform_inputs(x=x, c=c, y=y)
        if noise is None:
            noise = draw_normals(self.noise_draws(observations=False),
                                 generator, (n, *x.shape[:-1]), x.device)
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor
        plain = (torch.compiler.is_compiling() or wrapped(x)
                 or wrapped(params.log_sigma_x))
        if plain:
            spans.count("latent.plain", model_type="S")
        op = latent.latent_gauss_reference if plain else latent.latent_gauss
        return op(params.encoder.heads(x_t), noise["z"],
                  params.prior_net_c.heads(c_t), params.prior_net_y.heads(y_t),
                  self.output_transform_zx, self.prior_x)

    def sample(self, params: DPIVAEParams, x, c, cond: bool = False,
               n: int = 1, grl_alpha=None, *, generator=None,
               noise: Noise = None, slots: Optional[Collection[int]] = None):
        """Sample noisy VAE predictions: (x_sample, xh_p, xh_d, c_sample,
        y_sample, zx, zc, zy, log q), each with a leading MC axis of n.

        Randomness comes from ``generator``, or from ``noise``, a mapping of
        standard normals: "z" (n, batch, nz) for the encoder, "z_prior"
        (n, batch, nz_c) when ``cond``, and "x", "c", "y" (n, batch, nd_*)
        for the observation noise.

        ``slots``, indices into the 9-tuple, computes only those outputs
        and what they need, with None in the other places: (4,) runs no
        decoder_x. The generator draws the same numbers either way, so
        each slot computed equals the full sample's bit for bit; a noise
        mapping needs "x", "c" and "y" only for the slots that read them.
        """
        slots = range(9) if slots is None else slots
        parts = {p for i in slots for p in _SLOT_PARTS.get(i, ())}
        # The generator draws the observation noise of every slot, used or
        # not, so that its stream does not depend on ``slots``; a noise
        # mapping needs only the slots' own.
        lead = (n, *x.shape[:-1])
        if noise is None:
            noise = draw_normals(self.noise_draws(cond), generator, lead,
                                 x.device)
        zx, zc, zy, dens_z, zx_in = self._encode_latents(
            params, x, c, cond, n, noise=noise)
        xh_p, xh_d, ch, log_sigma_c, yh, log_sigma_y = self.decode(
            params, zx_in, zc, zy, grl_alpha=grl_alpha, parts=parts)
        eps = {name: _normal(noise, name, (*lead, getattr(self, width)), zx)
               if slot in slots else None
               for slot, name, width in OBSERVATION_NOISE}
        eps_x, eps_c, eps_y = eps["x"], eps["c"], eps["y"]
        x_sample = c_sample = y_sample = None
        if 0 in slots:
            x_sample = xh_p + xh_d + torch.exp(params.log_sigma_x) * eps_x
        if 3 in slots:
            c_sample = ch + torch.exp(log_sigma_c) * eps_c
        if 4 in slots:
            y_sample = yh + torch.exp(log_sigma_y) * eps_y
        full = (x_sample, xh_p, xh_d, c_sample, y_sample, zx, zc, zy, dens_z)
        return tuple(a if i in slots else None for i, a in enumerate(full))
