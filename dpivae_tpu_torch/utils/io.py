"""Loading the bundled case artifacts (counterpart of
dpivae_tpu/utils/io.py:74-88). Numpy only."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def load_mlp_npz(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load an MLP archive written by the JAX package's ``save_mlp_npz``.

    Returns ``({"layers": ({"w": (in, out), "b": (out,)}, ...)}, extras)``;
    extras holds every non-layer array (scaler stats, datasets).
    """
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    layers = []
    i = 0
    while f"w{i}" in arrays:
        layers.append({"w": arrays.pop(f"w{i}"), "b": arrays.pop(f"b{i}")})
        i += 1
    return {"layers": tuple(layers)}, arrays
