"""What the harness's parts share: finding a cell's files by name, seeds,
the benchmark's inputs, and the program's configuration checked against
the configuration file."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(kind: str, name: str) -> Path:
    """The file of a configuration ("configs"), a traffic mix ("traffic"),
    a cell's limits ("limits") or a per-layer metric ("metrics") by name."""
    suffix = ".py" if kind == "metrics" else ".json"
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def read_json(kind: str, name: str) -> dict:
    with open(find(kind, name)) as f:
        return json.load(f)


def cell(bench: dict, workload: str):
    """(workload entry, configuration, traffic mix, limits) of a cell."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return (w, read_json("configs", w["config"]),
                    read_json("traffic", w["traffic"]),
                    read_json("limits", workload))
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def driver(kind: str):
    """The driver module of a traffic mix's ``kind``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """The ``read(rec)`` function of a per-layer metric's own file."""
    path = find("metrics", name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys]
                                   ).generate_state(2, dtype=np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def surrogate_arrays(cfg, device) -> Dict[str, torch.Tensor]:
    """The case's surrogate weights from its archive, on ``device``."""
    with np.load(ROOT / cfg["surrogate"]) as data:
        return {k: torch.as_tensor(data[k], dtype=torch.float32, device=device)
                for k in data.files if k[0] in "wb" or k.startswith("scaler")}


def train_config(cfg, **overrides):
    """The program's ``TrainConfig`` of a configuration file (its case's
    preset), with ``overrides``, after checking that every size the file
    states is what the program runs."""
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.models.decoders import DECODER_X_HIDDEN

    case = get_case(cfg["case"])
    tc = TrainConfig().with_preset(case.presets[cfg["preset"]]).replace(
        **overrides)
    stated = {
        "model_type": (tc.model_type, cfg["model_type"]),
        "nz_x": (case.nz_x, cfg["nz_x"]), "nz_c": (tc.nz_c, cfg["nz_c"]),
        "nz_y": (tc.nz_y, cfg["nz_y"]), "nd_x": (case.nd_x, cfg["nd_x"]),
        "nd_c": (case.nd_c, cfg["nd_c"]), "nd_y": (case.nd_y, cfg["nd_y"]),
        "decoder_x_hidden": (DECODER_X_HIDDEN, cfg["decoder_x_hidden"]),
        "lambda_g0": (tc.lambda_g0, cfg["lambda_g0"]),
        "idx_c_phys": (list(case.idx_c_phys), []),
        "hidden_width": (tc.hidden_width, None),
        "full_cov_prior": (tc.full_cov_prior, False),
        "lambda_x": (tc.lambda_x, None),
        "use_pallas": (tc.use_pallas, cfg["use_pallas"]),
        "compute_dtype": (tc.compute_dtype, None),
        "clip_gradients": (tc.clip_gradients, False),
    }
    for key in ("n_train", "n_val", "n_batch", "n_mc_train", "n_mc_val",
                "n_mc_test", "val_freq", "alpha_x", "alpha_c", "alpha_y"):
        stated[key] = (getattr(tc, key), cfg[key])
    stated["beta_x"] = (tc.beta_x0, cfg["beta_x"])
    for group, field in (("encoder", "lr_e"), ("prior_net_c", "lr_p"),
                         ("prior_net_y", "lr_p"), ("decoder_x", "lr_dx"),
                         ("decoder_c", "lr_dc"), ("decoder_y", "lr_dy"),
                         ("log_sigma_x", "lr_sigma")):
        stated[f"lr.{group}"] = (getattr(tc, field), cfg["adam"]["lr"][group])
    for field in ("wd_e", "wd_p", "wd_dx", "wd_dc", "wd_dy", "wd_sigma"):
        stated[field] = (getattr(tc, field), 0.0)
    for fld in ("lambda", "beta_x", "beta_c", "beta_y"):
        stated[f"{fld}_annealing"] = (getattr(tc, f"{fld}_annealing"), None)
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the program's configuration differs from "
                         f"{cfg['name']}.json: {wrong} (program, file)")
    return tc, case


def cuda_or_exit(chips: int) -> torch.device:
    """The card, or exit: a measurement that finds fewer cards than the
    cell asks for stops without a result, and never falls back to the
    CPU."""
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this "
              f"machine has {n}; no result", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def sync(device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU,
    where the CPU tests drive the harness)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device) -> None:
    """After the window: waits, then returns the program's freed memory
    to the card before the reference runs."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
