"""The figures (counterpart of dpivae_tpu/viz/visualization.py): loss
curves, regression error, the ground-truth-vs-posterior pairplot, the
latent-traversal KDE grids and the physics / data-driven / combined
prediction decompositions.

Each figure is two halves:

- its data, computed with torch alone on the device (``traversal_data``,
  ``pred_decomposition``, ``corner_data``, ``marginal_post_data``,
  ``marginal_prior_data``, ``ground_truth_posterior_data``). Each decode
  of a prediction figure runs decoder_x's data branch, so through the
  fused-MLP kernel where the model's ``use_pallas`` asks for it;
- its drawing, the nine functions below ``save_close_fig``, which move
  the data to the host once and draw it. matplotlib, seaborn and pandas
  are imported inside them only, so that this module imports on a host
  without them (the card has none).

Traversals: each factor sweeps from the ground-truth distribution's
icdf(ALPHA_INTERP) to its icdf(1 - ALPHA_INTERP) while the others stay at
their ``val``, and the data at each point come from ``sample_response``
with the factors fixed.

Randomness follows the JAX module's key structure, carried over as seed
paths: a key is a tuple of ints, ``fold_in`` appends one, ``split``
appends one of its own range, and ``key_generator`` seeds a
``torch.Generator`` on the device from the whole path. A figure's seed is
the path's root, as JAX's key is. torch's streams are not JAX's, so the
figures' samples differ from the JAX package's at the same seed; every
data function takes the data and the standard normals of each traversal
point instead (``data=``, ``noise=``), which is how the tests hand it
JAX's.

Every function that computes data runs on the CUDA device unless
``device`` says otherwise, and the params must be there. There its
sampling calls replay CUDA graphs (``cuda_graph="auto"``,
``utils/graph_cache.py``), as the JAX module jits them: one graph per
(n_plot, slots) signature, replayed at each traversal point with that
point's seed; ``cuda_graph=False`` runs them eagerly.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dpivae_tpu_torch.train.graph import resolve_cuda_graph
from dpivae_tpu_torch.utils import (
    ALPHA_INTERP,
    CMAP_NAME,
    CMAP_VARS,
    DeviceLike,
    resolve_device,
    to_numpy,
)
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.graph_cache import (
    cached_sample,
    cached_sample_prior,
)

Key = Union[int, Tuple[int, ...]]

# The JAX module sets matplotlib's figure dpi to 150 when it is imported;
# here each figure is made at it.
DPI = 150
# Appended by ``split``: far above any fold_in index the figures use.
_SPLIT = 1 << 31
# pred_decomposition's statistics, each (n_interp, nd_x).
PRED_STATS = ("x_data_mean", "xh_mean", "xh_std", "xp_mean", "xp_std",
              "xd_mean", "xd_std")


# ----------------------------------------------------------------------
# Seed paths
# ----------------------------------------------------------------------

def _path(key: Key) -> Tuple[int, ...]:
    return (int(key),) if isinstance(key, (int, np.integer)) else tuple(key)


def fold_in(key: Key, i: int) -> Tuple[int, ...]:
    """The key of ``i`` under ``key`` (JAX's ``fold_in``)."""
    return (*_path(key), int(i))


def split(key: Key, n: int = 2) -> List[Tuple[int, ...]]:
    """``n`` keys under ``key``, apart from every ``fold_in`` (JAX's
    ``split``)."""
    return [(*_path(key), _SPLIT + j) for j in range(n)]


def key_generator(key: Key, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from the whole path of ``key``."""
    seed = np.random.SeedSequence(list(_path(key))).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


# ----------------------------------------------------------------------
# Figure data (torch only, on the device)
# ----------------------------------------------------------------------

def traversal_bounds(case) -> Tuple[np.ndarray, np.ndarray]:
    """Per-factor traversal bounds: the ground-truth distribution's
    icdf(ALPHA_INTERP) and icdf(1 - ALPHA_INTERP), each (n_factors,)."""
    dist = case.gt_dist()
    n = len(case.factors)
    lb = to_numpy(dist.icdf(torch.full((1, n), ALPHA_INTERP)))[0]
    ub = to_numpy(dist.icdf(torch.full((1, n), 1.0 - ALPHA_INTERP)))[0]
    return lb, ub


def traversal_grid(case, idx: int, n_interp: int):
    """All factors at their ``val`` and factor ``idx`` swept across its
    traversal bounds: (z (n_interp, n_factors), the swept values)."""
    lb, ub = traversal_bounds(case)
    vals = np.asarray([f.val for f in case.factors], np.float32)
    sweep = np.linspace(lb[idx], ub[idx], n_interp, dtype=np.float32)
    z = np.tile(vals, (n_interp, 1))
    z[:, idx] = sweep
    return z, sweep


def traversal_data(case, idx: int, n_interp: int, n_plot: int,
                   generator: torch.Generator, device: DeviceLike = None):
    """(x, c, y, sweep): ``n_plot`` responses at each traversal point of
    factor ``idx``, x, c and y of shape (n_plot, n_interp, nd_*), on
    ``device`` (None means CUDA), drawn from ``generator``."""
    z, sweep = traversal_grid(case, idx, n_interp)
    x, c, y, _ = sample_response(case, generator, n_plot, z=z, device=device)
    return x, c, y, sweep


def _points(case, idx, n_interp, n_plot, key, data, device):
    """The traversal data: drawn from ``key``'s generator, or ``data``
    (x, c, y), each (n_plot, n_interp, nd_*), placed on ``device``."""
    if data is None:
        return traversal_data(case, idx, n_interp, n_plot,
                              key_generator(key, device), device)
    x, c, y = (torch.as_tensor(a, dtype=torch.float32, device=device)
               for a in data)
    return x, c, y, traversal_grid(case, idx, n_interp)[1]


def _sample_points(model, params, config, x, c, cond, keys, noise, slots,
                   cuda_graph):
    """``model.sample`` with n = 1 at each traversal point i, on x[:, i]
    and c[:, i] (contiguous copies, as a graph's static buffers hold
    them), from the generator of ``keys[i]`` or from ``noise[i]``; only
    ``slots`` are computed. Graphed, each point replays the graph of the
    (n_plot, slots) signature."""
    sample = (functools.partial(cached_sample, model)
              if resolve_cuda_graph(cuda_graph, x.device) else model.sample)
    outs = []
    for i in range(x.shape[1]):
        draw = (dict(noise=noise[i]) if noise is not None else
                dict(generator=key_generator(keys[i], x.device)))
        outs.append(sample(params, x[:, i].contiguous(),
                           c[:, i].contiguous(), cond=cond, n=1,
                           grl_alpha=config.lambda_g0, slots=slots, **draw))
    return outs


@torch.no_grad()
def pred_decomposition(model, params, config, case, idx: int, n_interp: int,
                       n_plot: int, cond: bool = False, key: Key = 0, *,
                       data=None, noise: Optional[Sequence] = None,
                       device: DeviceLike = None, cuda_graph="auto"):
    """The data of ``plot_pred`` and of one column of ``plot_interp_pred``:
    at each traversal point of factor ``idx``, the mean and (population)
    std over the n_plot axis of x̂ = x_sample, x̂_p and x̂_d, and the data's
    mean. Returns ({name in PRED_STATS: (n_interp, nd_x)}, sweep).

    ``key`` splits into the data's key and the samples' key, whose
    ``fold_in(i)`` draws point i."""
    device = resolve_device(device)
    k_data, k_samp = split(key)
    x, c, _, sweep = _points(case, idx, n_interp, n_plot, k_data, data,
                             device)
    outs = _sample_points(model, params, config, x, c, cond,
                          [fold_in(k_samp, i) for i in range(n_interp)],
                          noise, slots=(0, 1, 2), cuda_graph=cuda_graph)
    stats = {name: [] for name in PRED_STATS}
    for i, out in enumerate(outs):
        stats["x_data_mean"].append(x[:, i].mean(dim=0))
        for name, a in zip(("xh", "xp", "xd"), out[:3]):
            stats[f"{name}_mean"].append(a[0].mean(dim=0))
            stats[f"{name}_std"].append(a[0].std(dim=0, correction=0))
    return {name: torch.stack(v) for name, v in stats.items()}, sweep


def _latents(model, params, config, x, c, cond, keys, noise, cuda_graph):
    """(zx, zc, zy), each (n_interp, n_plot, nz_*): the posterior latents
    at each traversal point; no decoder runs."""
    outs = _sample_points(model, params, config, x, c, cond, keys, noise,
                          slots=(5, 6, 7), cuda_graph=cuda_graph)
    return tuple(torch.stack([out[s][0] for out in outs]) for s in (5, 6, 7))


@torch.no_grad()
def corner_data(model, params, config, case, idx: int, n_interp: int,
                n_plot: int, cond: bool = False, key: Key = 0, *, data=None,
                noise: Optional[Sequence] = None, device: DeviceLike = None,
                cuda_graph="auto"):
    """The data of ``interp_corner_latent_space``: ((zx, zc, zy) at each
    traversal point of factor ``idx``, each (n_interp, n_plot, nz_*),
    sweep). ``key`` splits into the data's key and the samples' key, whose
    ``fold_in(i)`` draws point i."""
    device = resolve_device(device)
    k_data, k_samp = split(key)
    x, c, _, sweep = _points(case, idx, n_interp, n_plot, k_data, data,
                             device)
    keys = [fold_in(k_samp, i) for i in range(n_interp)]
    return _latents(model, params, config, x, c, cond, keys, noise,
                    cuda_graph), sweep


@torch.no_grad()
def marginal_post_data(model, params, config, case, idx: int, n_interp: int,
                       n_plot: int, cond: bool = False, key: Key = 0, *,
                       data=None, noise: Optional[Sequence] = None,
                       device: DeviceLike = None, cuda_graph="auto"):
    """The data of one column of ``plot_marginal_post``: ((zx, zc, zy) at
    each traversal point of factor ``idx``, sweep). The factor's key,
    ``fold_in(key, idx)``, draws the data, and its ``fold_in(2000 + i)``
    point i."""
    device = resolve_device(device)
    k_data = fold_in(key, idx)
    x, c, _, sweep = _points(case, idx, n_interp, n_plot, k_data, data,
                             device)
    keys = [fold_in(k_data, 2000 + i) for i in range(n_interp)]
    return _latents(model, params, config, x, c, cond, keys, noise,
                    cuda_graph), sweep


@torch.no_grad()
def marginal_prior_data(model, params, config, case, idx: int,
                        n_interp: int, n_plot: int, key: Key = 0, *,
                        data=None, noise: Optional[Sequence] = None,
                        device: DeviceLike = None, cuda_graph="auto"):
    """The data of one column of ``plot_marginal_prior``: ((zc, zy) drawn
    from the learned priors p(z_c|c) and p(z_y|y) at each traversal point
    of factor ``idx``, each (n_interp, n_plot, nz_*), sweep). The factor's
    key, ``fold_in(key, idx)``, draws the data, and its
    ``fold_in(1000 + i)`` point i; ``noise[i]`` is ``sample_prior``'s
    mapping."""
    device = resolve_device(device)
    k_data = fold_in(key, idx)
    _, c, y, sweep = _points(case, idx, n_interp, n_plot, k_data, data,
                             device)
    sample_prior = (functools.partial(cached_sample_prior, model)
                    if resolve_cuda_graph(cuda_graph, device) else
                    functools.partial(model.sample_prior, device=device))
    zc, zy = [], []
    for i in range(n_interp):
        draw = (dict(noise=noise[i]) if noise is not None else dict(
            generator=key_generator(fold_in(k_data, 1000 + i), device)))
        out = sample_prior(params, c[:, i].contiguous(),
                           y[:, i].contiguous(), n=1, **draw)
        zc.append(out[0][0])
        zy.append(out[2][0])
    return (torch.stack(zc), torch.stack(zy)), sweep


@torch.no_grad()
def ground_truth_posterior_data(model, params, config, case, sample_dist,
                                n_plot: int, cond: bool = False,
                                key: Key = 0, *, data=None, noise=None,
                                prior_samples=None,
                                device: DeviceLike = None,
                                cuda_graph="auto"):
    """The data of ``plot_ground_truth_posterior``: (the ground-truth z_x
    of n_plot responses drawn from ``sample_dist``, the posterior z_x of
    those responses, n_plot draws of the fixed z_x prior), each
    (n_plot, nz_x). ``key`` splits into the data's, the samples' and the
    prior draws' keys; ``data`` (x, c, z), ``noise`` (``sample``'s
    mapping) and ``prior_samples`` take their places."""
    device = resolve_device(device)
    k_data, k_samp, k_prior = split(key, 3)
    if data is None:
        x, c, _, z = sample_response(case, key_generator(k_data, device),
                                     n_plot, sample_dist=sample_dist,
                                     device=device)
    else:
        x, c, z = (torch.as_tensor(a, dtype=torch.float32, device=device)
                   for a in data)
    if prior_samples is None:
        prior_samples = case.prior_x_dist().sample(
            key_generator(k_prior, device), (n_plot,))
    prior_samples = torch.as_tensor(prior_samples, dtype=torch.float32,
                                    device=device)
    (out,) = _sample_points(model, params, config, x[:, None], c[:, None],
                            cond, [k_samp], None if noise is None else [noise],
                            slots=(5,), cuda_graph=cuda_graph)
    return z[:, list(case.z_idx_x)], out[5][0], prior_samples


# ----------------------------------------------------------------------
# Drawing (matplotlib, seaborn and pandas imported here only)
# ----------------------------------------------------------------------

def missing_plot_package(packages=("matplotlib", "seaborn")) -> Optional[str]:
    """The first of ``packages`` that does not import here, or None: the
    programs' ``--plots`` check, made before any work."""
    import importlib

    for name in packages:
        try:
            importlib.import_module(name)
        except ImportError:
            return name
    return None


def save_close_fig(fig, path, show=False):
    """Save ``fig`` to ``path``, then show or close it."""
    from matplotlib import pyplot as plt

    fig.savefig(path)
    if show:
        plt.show()
    else:
        plt.close(fig)


def _colorbar(fig, ax, sweep, label, color, orientation="horizontal",
              location="top", **kwargs):
    """A colour bar of the traversal's values on ``ax``; returns the
    traversal's colours."""
    import matplotlib as mpl
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import LinearSegmentedColormap, Normalize

    n_interp = len(sweep)
    cmap_interp = mpl.colormaps[CMAP_NAME](np.linspace(0.0, 1.0, n_interp))
    smap = ScalarMappable(
        Normalize(vmin=sweep[0], vmax=sweep[-1]),
        cmap=LinearSegmentedColormap.from_list(CMAP_NAME, cmap_interp,
                                               N=n_interp),
    )
    cbar = fig.colorbar(smap, ax=ax, orientation=orientation,
                        location=location, **kwargs)
    cbar.set_label(label=label, size=14, color=color)
    cbar.ax.tick_params(labelsize=10)
    return cmap_interp


def _frame(columns_data, labels, type_values):
    """A pandas frame of ``columns_data`` (n, k) under ``labels``, with a
    leading "type" column."""
    import pandas as pd

    df = pd.DataFrame(columns_data, columns=labels)
    df.insert(0, "type", type_values)
    return df


def visualize_training_loss(logs, n_skip_train=0, n_skip_val=0):
    """5-row loss-curve figure of a ``TrainLogs``: ELBO, Rx, Ry, Rc and KL,
    training against validation on twin axes."""
    from matplotlib import pyplot as plt

    it_tr, elbo = logs.scalars("ELBO")
    it_va, elbo_val = logs.scalars("ELBO_val")

    fig, ax = plt.subplots(5, 1, figsize=(16, 9), dpi=DPI)

    ax[0].plot(it_tr[n_skip_train:], elbo[n_skip_train:], label="Training",
               c="blue", alpha=0.3)
    ax[0].scatter(it_va[n_skip_val:], elbo_val[n_skip_val:],
                  label="Validation", c="red")
    ax[0].grid()
    ax[0].set_ylabel("ELBO")

    rows = [("Rx", "Rx_val"), ("Ry", "Ry_val"), ("Rc", "Rc_val"),
            ("KLx", "KLx_val")]
    ylabels = ["Rx", "Ry", "Rc", "KL"]
    for k, ((tr_name, va_name), ylab) in enumerate(zip(rows, ylabels), start=1):
        _, tr = logs.scalars(tr_name)
        _, va = logs.scalars(va_name)
        ax[k].plot(it_tr[n_skip_train:], tr[n_skip_train:], c="blue", alpha=0.8)
        ax_t = ax[k].twinx()
        ax_t.plot(it_va[n_skip_val:], va[n_skip_val:], color="red")
        ax[k].yaxis.label.set_color("blue")
        ax[k].tick_params(axis="y", colors="blue")
        ax_t.yaxis.label.set_color("red")
        ax_t.tick_params(axis="y", colors="red")
        ax[k].grid()
        ax[k].set_ylabel(ylab)
        ax_t.set_ylabel(f"{ylab}_val")
    return fig, ax


def plot_regression_error(y_test, y_pred, case, metrics=None, title=None):
    """ŷ-vs-y scatter with the diagonal and the metrics written in, one
    panel per y dimension."""
    from matplotlib import pyplot as plt

    labels = [f.label for f in case.factors]
    z_idx_y = list(case.z_idx_y)
    nd_y = case.nd_y

    y_test = to_numpy(y_test)
    y_pred = to_numpy(y_pred)
    if y_test.ndim == 1:
        y_test = y_test[:, None]
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]

    fig, ax = plt.subplots(1, nd_y, figsize=(3 * nd_y, 4), dpi=DPI)
    ax = np.atleast_1d(ax)
    for i in range(nd_y):
        diag = np.array([y_pred[:, i].min(), y_pred[:, i].max()])
        ax[i].scatter(y_test[:, i], y_pred[:, i], c="red", s=3.0)
        ax[i].plot(diag, diag, linestyle="dashed", c="black", linewidth=2.0,
                   alpha=0.5)
        if metrics is not None:
            for j, (name, score) in enumerate(metrics.items()):
                ax[i].text(0.1, 0.90 - j * 0.05,
                           f"{name}={score[i]:.3f}", fontsize=12,
                           transform=ax[i].transAxes)
        ax[i].set_title(labels[z_idx_y[i]])
        ax[i].grid()
    if title is not None:
        fig.suptitle(title)
    return fig, ax


def plot_ground_truth_posterior(model, params, config, case, sample_dist,
                                n_plot=1000, cond=False, seed=0,
                                device: DeviceLike = None):
    """Pairplot of {prior, ground truth, aggregated posterior} over the
    physics latents."""
    import pandas as pd
    import seaborn as sns

    z_gt, zx_post, prior = (to_numpy(a) for a in ground_truth_posterior_data(
        model, params, config, case, sample_dist, n_plot, cond=cond,
        key=seed, device=device))
    labels = [f.label for f in case.factors if f.type == "x"]
    frames = [_frame(prior, labels, ["Prior"] * n_plot),
              _frame(z_gt, labels, ["Ground truth"] * n_plot),
              _frame(zx_post, labels, ["Posterior Zp"] * n_plot)]
    grid = sns.pairplot(pd.concat(frames), hue="type", kind="hist")
    grid.figure.set_dpi(DPI)
    grid.figure.suptitle("Ground truth and posterior " + r"$z_p$")
    return grid.figure


def interp_corner_latent_space(model, params, config, case, idx_z_interp,
                               n_interp, n_plot=1000, cond=False, seed=0,
                               device: DeviceLike = None):
    """Pairplot of the posterior (z_x ‖ z_y) while one factor traverses."""
    import pandas as pd
    import seaborn as sns

    labels = [f.label for f in case.factors]
    (zx, _, zy), sweep = corner_data(model, params, config, case,
                                     idx_z_interp, n_interp, n_plot,
                                     cond=cond, key=seed, device=device)
    z = np.concatenate((to_numpy(zx), to_numpy(zy)), axis=-1)
    frames = [_frame(z[i], None,
                     [f"{labels[idx_z_interp]} = {sweep[i]:.4g}"] * n_plot)
              for i in range(n_interp)]
    grid = sns.pairplot(pd.concat(frames), hue="type", kind="hist",
                        diag_kind="kde", palette="plasma")
    grid.figure.set_dpi(DPI)
    grid.figure.suptitle("Posterior")
    return grid.figure


def _kde_column(ax, z, sweep, labels, label_colors=None):
    """One KDE per latent (rows of ``ax``), the traversal's points as
    hues; ``z`` is (n_interp, n_plot, n_latents)."""
    import pandas as pd
    import seaborn as sns

    n_plot = z.shape[1]
    df_all = pd.concat([_frame(z[i], labels, [float(sweep[i])] * n_plot)
                        for i in range(len(sweep))])
    for j, label in enumerate(labels):
        sns.kdeplot(data=df_all, x=label, hue="type", palette="plasma",
                    ax=ax[j], fill=True, legend=False)
        ax[j].spines[["right", "top"]].set_visible(False)
        ax[j].set(yticklabels=[])
        ax[j].set_yticks([])
        if label_colors is None:
            ax[j].set_ylabel(label)
        else:
            ax[j].set_ylabel(label, color=label_colors[j], size=12)
        ax[j].set_xlabel(None)


def plot_marginal_prior(model, params, config, case, n_plot=1000, seed=0,
                        device: DeviceLike = None):
    """KDE grid of the learned priors' marginals p(z_c|c), p(z_y|y) while
    each factor traverses, a colour bar per factor."""
    from matplotlib import pyplot as plt

    n_interp = config.n_interp
    nz_c, nz_y = config.nz_c, config.nz_y
    n_factors = len(case.factors)
    z_labels = ([r"$z_\mathrm{c}$" + rf"$_{{{i}}}$" for i in range(nz_c)]
                + [r"$z_\mathrm{y}$" + rf"$_{{{i}}}$" for i in range(nz_y)])

    fig, ax = plt.subplots(nz_c + nz_y, n_factors, figsize=(12, 6), dpi=DPI,
                           layout="compressed", sharey="row", sharex="row")
    ax = np.atleast_2d(ax)
    for idx, factor in enumerate(case.factors):
        (zc, zy), sweep = marginal_prior_data(
            model, params, config, case, idx, n_interp, n_plot, key=seed,
            device=device)
        z = np.concatenate((to_numpy(zc), to_numpy(zy)), axis=-1)
        _kde_column(ax[:, idx], z, sweep, z_labels)
        _colorbar(fig, ax[0, idx], sweep, factor.label, "black",
                  fraction=1.0, pad=0.2)
    return fig, ax


def plot_marginal_post(model, params, config, case, vars_interp=None,
                       n_plot=1000, cond=False, seed=0,
                       device: DeviceLike = None):
    """KDE grid of the posterior marginals of every latent block while the
    factors of ``vars_interp`` (default all) traverse."""
    from matplotlib import pyplot as plt

    n_interp = config.n_interp
    nz_x, nz_c, nz_y = case.nz_x, config.nz_c, config.nz_y
    n_z = nz_x + nz_c + nz_y
    if vars_interp is None:
        vars_interp = range(len(case.factors))
        figsize = (15, 8)
    else:
        figsize = (3 * len(vars_interp), 0.8 * n_z)
    vars_interp = list(vars_interp)

    z_labels = ([f.label for f in case.factors if f.type == "x"]
                + [r"$z_\mathrm{c},$" + rf"$_{{{i + 1}}}$" for i in range(nz_c)]
                + [r"$z_\mathrm{y},$" + rf"$_{{{i + 1}}}$" for i in range(nz_y)])
    z_colors = [CMAP_VARS[t] for t in ["x"] * nz_x + ["c"] * nz_c
                + ["y"] * nz_y]

    fig, ax = plt.subplots(n_z, len(vars_interp), figsize=figsize, dpi=DPI,
                           layout="compressed", sharex="row")
    ax = np.atleast_2d(ax)
    for col, idx in enumerate(vars_interp):
        latents, sweep = marginal_post_data(
            model, params, config, case, idx, n_interp, n_plot, cond=cond,
            key=seed, device=device)
        z = np.concatenate([to_numpy(a) for a in latents], axis=-1)
        _kde_column(ax[:, col], z, sweep, z_labels, z_colors)
        factor = case.factors[idx]
        _colorbar(fig, ax[0, col], sweep, factor.label,
                  CMAP_VARS[factor.type], fraction=1.0, pad=0.2)
    return fig, ax


def _pred_bands(ax, t, stats, sweep, factor, colors, band_alpha,
                data_kw, mean_kw):
    """The three panels of a prediction decomposition: x̂_p, x̂_d and x̂,
    each mean ± 2 std per traversal point, with the data's mean on x̂."""
    for i in range(len(sweep)):
        color = colors[i]
        for a, name, alpha in zip(ax, ("xp", "xd", "xh"), band_alpha):
            mean, std = stats[f"{name}_mean"][i], stats[f"{name}_std"][i]
            a.fill_between(t, mean - 2 * std, mean + 2 * std, alpha=alpha,
                           color=color)
        ax[0].plot(t, stats["xp_mean"][i], alpha=0.5, color=color,
                   label=factor.label + rf"$={sweep[i]:.3f}$")
        ax[1].plot(t, stats["xd_mean"][i], alpha=0.5, color=color)
        ax[2].plot(t, stats["xh_mean"][i], color=color, **mean_kw)
        ax[2].scatter(t, stats["x_data_mean"][i], color=color, **data_kw)


def _host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: to_numpy(a) for name, a in stats.items()}


def _pred_ylabels(ax, case):
    ax[0].set_ylabel(r"$\hat{x_\mathrm{p}}$ " + case.y_unit, fontsize=18)
    ax[1].set_ylabel(r"$\hat{x_\mathrm{d}}$ " + case.y_unit, fontsize=18)
    ax[2].set_ylabel(r"$\hat{x}$ " + case.y_unit, fontsize=18)


def plot_interp_pred(model, params, config, case, n_interp=None, n_plot=1000,
                     cond=False, seed=0, device: DeviceLike = None):
    """3 x n_factors grid: x̂_p, x̂_d and x̂ = x̂_p + x̂_d, mean ± 2σ bands,
    one column per factor traversal."""
    import matplotlib as mpl
    from matplotlib import pyplot as plt

    n_interp = n_interp or config.n_interp
    t = np.asarray(case.t)
    n_factors = len(case.factors)
    colors = mpl.colormaps[CMAP_NAME](np.linspace(0.0, 1.0, n_interp))

    fig, ax = plt.subplots(3, n_factors, figsize=(16, 9), dpi=DPI,
                           sharex="col", sharey="row", layout="compressed")
    ax = np.atleast_2d(ax)
    for idx, factor in enumerate(case.factors):
        stats, sweep = pred_decomposition(
            model, params, config, case, idx, n_interp, n_plot, cond,
            fold_in(seed, idx), device=device)
        _pred_bands(ax[:, idx], t, _host(stats), sweep, factor, colors,
                    (0.5, 0.3, 0.5), {}, dict(alpha=0.5))
        for row in range(3):
            ax[row, idx].grid()
        ax[2, idx].set_xlabel(case.x_unit, fontsize=16)
        _colorbar(fig, ax[0, idx], sweep, factor.label,
                  CMAP_VARS[factor.type])
    _pred_ylabels(ax[:, 0], case)
    return fig, ax


def plot_pred(model, params, config, case, idx_var_gt, n_interp=None,
              n_plot=1000, cond=False, seed=0, device: DeviceLike = None):
    """1 x 3 prediction decomposition while one factor traverses."""
    import matplotlib as mpl
    from matplotlib import pyplot as plt

    n_interp = n_interp or config.n_interp
    t = np.asarray(case.t)
    factor = case.factors[idx_var_gt]
    colors = mpl.colormaps[CMAP_NAME](np.linspace(0.0, 1.0, n_interp))

    fig, ax = plt.subplots(1, 3, figsize=(9, 3), dpi=DPI, layout="compressed")
    stats, sweep = pred_decomposition(
        model, params, config, case, idx_var_gt, n_interp, n_plot, cond, seed,
        device=device)
    _pred_bands(ax, t, _host(stats), sweep, factor, colors,
                (0.2, 0.2, 0.2), dict(alpha=1.0, s=8.0),
                dict(alpha=1.0, linestyle="solid"))
    for a in ax:
        a.grid()
        a.set_xlabel(case.x_unit, fontsize=16)
    _colorbar(fig, ax[-1], sweep, factor.label, CMAP_VARS[factor.type],
              orientation="vertical", location="right")
    _pred_ylabels(ax, case)
    return fig, ax
