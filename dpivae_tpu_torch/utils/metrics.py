"""Regression metrics (counterpart of dpivae_tpu/utils/metrics.py).

Per-output-dim R², MSE and MAE in numpy, equal to scikit-learn's
``multioutput="raw_values"``. Tensors are read back to the host first.
"""

from __future__ import annotations

import numpy as np

from dpivae_tpu_torch.utils import to_numpy


def r2_score_raw(y_true, y_pred) -> np.ndarray:
    y_true, y_pred = to_numpy(y_true), to_numpy(y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2, axis=0)
    ss_tot = np.sum((y_true - np.mean(y_true, axis=0)) ** 2, axis=0)
    return 1.0 - ss_res / ss_tot


def mse_raw(y_true, y_pred) -> np.ndarray:
    y_true, y_pred = to_numpy(y_true), to_numpy(y_pred)
    return np.mean((y_true - y_pred) ** 2, axis=0)


def mae_raw(y_true, y_pred) -> np.ndarray:
    y_true, y_pred = to_numpy(y_true), to_numpy(y_pred)
    return np.mean(np.abs(y_true - y_pred), axis=0)


def regression_metrics(y_test, y_pred) -> dict:
    """R², MSE and MAE, each per output dim."""
    return {
        "R2": r2_score_raw(y_test, y_pred),
        "MSE": mse_raw(y_test, y_pred),
        "MAE": mae_raw(y_test, y_pred),
    }
