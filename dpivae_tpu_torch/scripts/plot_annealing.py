"""The annealing schedules' figure (counterpart of scripts/plot_annealing.py):

    python -m dpivae_tpu_torch.scripts.plot_annealing [--n_iter 30000] \\
        [--mu 0.1] [--cov 0.15] [--n_cycles 5] [--R 0.5] \\
        [--out annealing.png]

Draws the port's ``cyclical_schedule`` and ``sigmoid_schedule``
(``utils.annealing``) over n_iter steps into --out. Needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np


def schedule_arrays(n_iter: int, mu: float, cov: float, n_cycles: int,
                    R: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(steps, cyclical weights, sigmoid weights), each (n_iter,)."""
    from dpivae_tpu_torch.utils.annealing import (
        cyclical_schedule,
        sigmoid_schedule,
    )

    cyc = cyclical_schedule(n_iter, n_cycles, R)
    sig = sigmoid_schedule(n_iter, mu, cov)
    t = np.arange(n_iter)
    return (t, np.array([cyc(i) for i in t], np.float32),
            np.array([float(sig(i)) for i in t], np.float32))


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n_iter", type=int, default=30_000)
    parser.add_argument("--mu", type=float, default=0.1)
    parser.add_argument("--cov", type=float, default=0.15)
    parser.add_argument("--n_cycles", type=int, default=5)
    parser.add_argument("--R", type=float, default=0.5)
    parser.add_argument("--out", default="annealing.png")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    t, y_cyc, y_sig = schedule_arrays(args.n_iter, args.mu, args.cov,
                                      args.n_cycles, args.R)
    fig, ax = plt.subplots()
    ax.plot(t, y_cyc, label="cyclical")
    ax.plot(t, y_sig, label="sigmoid")
    ax.legend()
    ax.grid()
    fig.savefig(args.out)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
