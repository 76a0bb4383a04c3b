"""Guards on dpivae_tpu_torch's boundaries: it imports neither jax nor the
JAX package, nor what the machine with the card lacks (scikit-learn,
pandas, pyarrow, orbax, matplotlib, seaborn), and its entry points do not
silently run on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.examples import custom_case, hyper_search, serve_http
from dpivae_tpu_torch.models.vae import DPIVAE
from dpivae_tpu_torch.parallel import make_mesh
from dpivae_tpu_torch.scripts import (
    disentanglement_metric,
    regression_comparison,
    single_run,
)
from dpivae_tpu_torch.serving import Predictor, load_predictor
from dpivae_tpu_torch.sweep import (
    train_hyper_sweep,
    train_sweep,
    train_sweep_data,
)
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.train.checkpoint import load_model, save_model
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.viz.visualization import traversal_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax_and_no_jax_package():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import dpivae_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            dpivae_tpu_torch.__path__, "dpivae_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        banned = ("jax", "jaxlib", "dpivae_tpu", "sklearn", "pandas",
                  "pyarrow", "orbax", "matplotlib", "seaborn")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in banned)
        print(len(names), bad)
        walked = {"dpivae_tpu_torch.parallel.mesh",
                  "dpivae_tpu_torch.ops.remat",
                  "dpivae_tpu_torch.examples.multichip_sweep",
                  "dpivae_tpu_torch.examples.hyper_search",
                  "dpivae_tpu_torch.examples.custom_case",
                  "dpivae_tpu_torch.examples.serve_http"} <= set(names)
        sys.exit(1 if bad or len(names) < 40 or not walked else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _on_cpu_mesh(fn):
    """``fn(mesh)`` with a one-rank CPU mesh, closed after."""
    mesh = make_mesh(1, device="cpu")
    try:
        return fn(mesh)
    finally:
        mesh.close()


def _entry_points(tmp_path):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=32, n_batch=16)
    gen = torch.Generator().manual_seed(0)
    data = sample_response(case, gen, 32, sample_dist=case.gt_dist(),
                           device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    bridge = get_case("bridge")
    p_cfg = TrainConfig().with_preset(bridge.presets["DPIVAE-A"]).replace(
        n_train=32, n_batch=16)
    p_data = sample_response(bridge, gen, 32, sample_dist=bridge.gt_dist(),
                             device="cpu")
    p_model = setup_model(p_cfg, bridge, p_data, device="cpu")
    saved = str(tmp_path / "model")
    save_model(saved, model, params, cfg, case=case)
    return {
        "sample_response": lambda: sample_response(
            case, gen, 4, sample_dist=case.gt_dist()),
        "setup_model": lambda: setup_model(cfg, case, data),
        "DPIVAE.init": lambda: model.init(gen),
        "init_params": lambda: init_params(cfg, model),
        "Predictor": lambda: Predictor(model, params, cfg),
        "train_model": lambda: train_model(cfg, model, case, data, data),
        "make_mesh": lambda: make_mesh(),
        "train_model(mesh=)": lambda: _on_cpu_mesh(
            lambda mesh: train_model(cfg, model, case, data, data,
                                     mesh=mesh)),
        "P model init_params": lambda: init_params(p_cfg, p_model),
        "load_model": lambda: load_model(saved, case),
        "single_run CLI": lambda: single_run.main(
            ["--n_iter", "2", "--output", str(tmp_path)]),
        "train_sweep": lambda: train_sweep(cfg, case, [0.1, -0.1]),
        "train_hyper_sweep": lambda: train_hyper_sweep(
            cfg, case, {"lr_e": [1e-3, 2e-3]}),
        "train_sweep_data": lambda: train_sweep_data(
            cfg, case, [0.1], tuple(a[None] for a in data[:3]),
            tuple(a[None] for a in data[:3])),
        "disentanglement_metric CLI": lambda: disentanglement_metric.main(
            ["--n_iter", "2", "--n_runs", "1", "--output", str(tmp_path)]),
        "regression_comparison CLI": lambda: regression_comparison.main(
            ["--n_iter", "2", "--n_runs", "1", "--output", str(tmp_path)]),
        # The device is resolved before the file is read.
        "load_predictor": lambda: load_predictor(
            str(tmp_path / "predictor.pt2")),
        "traversal_data": lambda: traversal_data(case, 0, 2, 4, gen),
        "DPIVAE.sample_prior": lambda: model.sample_prior(
            params, data[1], data[2], generator=gen),
        "hyper_search example": lambda: hyper_search.main(
            ["--n_iter", "2", "--n_runs", "1"]),
        "custom_case example": lambda: custom_case.main(["--n_iter", "2"]),
        "serve_http example": lambda: serve_http.main(
            ["--artifact", str(tmp_path / "predictor.pt2"), "--port", "0"]),
    }


@pytest.mark.parametrize("entry", [
    "sample_response", "setup_model", "DPIVAE.init", "init_params",
    "Predictor", "train_model", "make_mesh", "train_model(mesh=)",
    "P model init_params", "load_model",
    "single_run CLI", "train_sweep", "train_hyper_sweep", "train_sweep_data",
    "disentanglement_metric CLI", "regression_comparison CLI",
    "load_predictor", "traversal_data", "DPIVAE.sample_prior",
    "hyper_search example", "custom_case example", "serve_http example"])
def test_entry_point_without_device_needs_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(tmp_path)[entry]()


def test_parallel_names_no_jax():
    """parallel/'s source imports neither jax nor the JAX package (the
    import walk above checks what importing it brings in)."""
    folder = os.path.join(REPO, "dpivae_tpu_torch", "parallel")
    names = [n for n in os.listdir(folder) if n.endswith(".py")]
    assert {"__init__.py", "mesh.py"} <= set(names)
    for name in names:
        with open(os.path.join(folder, name)) as f:
            source = f.read()
        assert "import jax" not in source and "from jax" not in source
        assert "dpivae_tpu." not in source.replace("dpivae_tpu_torch", "")


def test_sample_needs_generator_or_noise():
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=32, n_batch=16)
    data = sample_response(case, torch.Generator().manual_seed(0), 32,
                           sample_dist=case.gt_dist(), device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    assert isinstance(model, DPIVAE)
    params = init_params(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model.sample(params, data[0], data[1], n=2)


def test_sample_response_with_fixed_factors():
    case = get_case("simple_beam")
    z = np.array([3.0, 0.5, 8.0, 5.0], np.float32)
    x, c, y, zs = sample_response(case, torch.Generator().manual_seed(0), 200,
                                  z=z, device="cpu")
    assert x.shape == (200, 32) and c.shape == (200, 1) and y.shape == (200, 1)
    assert torch.equal(zs, torch.from_numpy(z).expand(200, 4))
    clean = case.full_model(torch.from_numpy(z)[None])
    # Observation noise has sigma 0.02: the sample mean sits within 5 sigma
    # of the noise-free response.
    assert float((x.mean(0) - clean[0]).abs().max()) < 5 * 0.02 / np.sqrt(200)
    assert abs(float(c.mean()) - 5.0) < 5 * 0.02 / np.sqrt(200)
    with pytest.raises(ValueError, match="sample_dist"):
        sample_response(case, torch.Generator(), 4, device="cpu")
