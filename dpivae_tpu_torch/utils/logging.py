"""Metric logs to CSV files and back (counterpart of
dpivae_tpu/utils/logging.py).

The same files and columns as the JAX package: ``train.csv`` (iter and
TRAIN_COLUMNS) and ``val.csv`` (iter and VAL_COLUMNS) with the active rows
only, and one ``<name>.csv`` (iter, value) per series. Written with the
standard library's ``csv`` module: each value as the shortest string that
reads back to the same float32 (as the JAX package's pyarrow and pandas
writers write its float32 logs), each iteration as an integer, so the
files parse to the same doubles as the JAX package's.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from dpivae_tpu_torch.train.train import TRAIN_COLUMNS, VAL_COLUMNS, TrainLogs


def _text(value) -> str:
    """An integer as such; a float as the shortest string that reads back
    to the same float32."""
    if isinstance(value, int):
        return str(value)
    return str(np.float32(value))


def _write_csv(path: str, columns, arrays) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in zip(*(a.tolist() for a in arrays)):
            writer.writerow([_text(v) for v in row])


def save_logs_csv(logs: TrainLogs, path_metrics: str) -> None:
    """Write the per-series CSVs and the combined ``train.csv`` and
    ``val.csv`` under ``path_metrics``."""
    os.makedirs(path_metrics, exist_ok=True)
    train = logs.train.cpu().numpy()
    val = logs.val.cpu().numpy()
    t_mask = logs.train_active.cpu().numpy()
    v_mask = logs.val_active.cpu().numpy()
    t_iters = np.arange(train.shape[0])[t_mask]
    v_iters = logs.val_iters.cpu().numpy()[v_mask]

    _write_csv(os.path.join(path_metrics, "train.csv"),
               ["iter", *TRAIN_COLUMNS], [t_iters, *train[t_mask].T])
    _write_csv(os.path.join(path_metrics, "val.csv"),
               ["iter", *VAL_COLUMNS], [v_iters, *val[v_mask].T])
    for name in TRAIN_COLUMNS + VAL_COLUMNS:
        iters, vals = logs.scalars(name)
        _write_csv(os.path.join(path_metrics, f"{name}.csv"),
                   ["iter", "value"], [iters, vals])


def get_logger_training_curve(logs: TrainLogs, label: str):
    """(iters, values) of a named series, as the reference's logger reads
    it back."""
    return logs.scalars(label)


def load_series_csv(path_metrics: str, name: str):
    """(iters, values) from a saved series CSV."""
    data = np.loadtxt(os.path.join(path_metrics, f"{name}.csv"),
                      delimiter=",", skiprows=1, ndmin=2)
    return data[:, 0].astype(int), data[:, 1]
