"""The criteria of ``reference_scale.py`` (the port's results at the
reference's full scale against BASELINE.md) on made-up readings: each
criterion hits where it should and misses where it should."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import reference_scale as rs  # noqa: E402

BEAM = rs.ANCHORS[0]
BRIDGE = rs.ANCHORS[3]


def _runs(r2, elbo_val):
    return [{"r2": {"VAE": list(r)}, "elbo_val": e}
            for r, e in zip(r2, elbo_val)]


@pytest.mark.parametrize("anchor,r2,elbo_val,want", [
    # the mean R² at the floor and the mean ELBO_val at the band's edge
    (BEAM, [(0.956,), (0.946,), (0.966,)], [-1.271, -1.271, -1.271],
     (True, True)),
    (BEAM, [(0.99,), (0.90,), (0.95,)], [-1.1, -1.1, -1.1], (False, True)),
    (BEAM, [(0.99,)] * 3, [-0.95, -0.96, -0.97], (True, False)),
    # per y dimension: the second misses its floor of 0.917
    (BRIDGE, [(0.98, 0.90), (0.98, 0.93), (0.98, 0.91)],
     [-5.4, -5.4, -5.4], (False, True)),
], ids=["edges", "r2-miss", "elbo-miss", "second-dim-miss"])
def test_anchor_criteria(anchor, r2, elbo_val, want):
    got = rs.anchor_criteria(anchor, _runs(r2, elbo_val))
    assert (got["r2"], got["elbo_val"]) == want
    assert got["hit"] == all(want)
    assert len(got["mean_r2_vae"]) == len(anchor["r2"]["VAE"])


def _table(scores):
    """(λ, factor, block) -> score from {(λ, factor): (zx, zc, zy)}."""
    return {(lam, f, b): s for (lam, f), row in scores.items()
            for b, s in zip(rs.BLOCKS, row)}


def test_study_means_average_over_runs():
    rows = [["zy", "zeta", 0.8, 4, 0, 100.0], ["zy", "zeta", 0.6, 4, 1, 100.0],
            ["zx", "zeta", "0.1", "4", "0", "100.00001"]]
    means = rs.study_means(rows)
    assert means[(100.0, "zeta", "zy")] == pytest.approx(0.7)
    assert means[(100.0, "zeta", "zx")] == pytest.approx(0.1)


def test_study_criteria():
    ref = _table({(1.0, "zeta"): (0.30, 0.01, 0.90),
                  (1.0, "m"): (0.10, 0.15, 0.00),
                  (1e4, "zeta"): (0.46, 0.00, 0.00)})
    same = rs.study_criteria(ref, ref)
    assert same["hit"] and same["mean_abs_diff"] == 0
    assert same["signal_keys"] == 3 and same["winner_agree"] == 3
    # m's winner flips between two blocks within NEAR_TIE in both: excused
    near = {**ref, (1.0, "m", "zx"): 0.20}
    got = rs.study_criteria(near, ref)
    assert got["hit"] and len(got["near_tie_flips"]) == 1
    # ζ's winner flips from z_y to z_x far apart: a miss
    flip = {**ref, (1.0, "zeta", "zx"): 0.95, (1.0, "zeta", "zy"): 0.2}
    got = rs.study_criteria(flip, ref)
    assert not got["winner"] and len(got["flips"]) == 1
    assert got["mean_abs_diff"] > rs.SCORE_TOL and not got["hit"]
    with pytest.raises(ValueError, match="keys"):
        rs.study_criteria({k: v for k, v in ref.items()
                           if k[1] != "m"}, ref)


def test_transfer_criteria():
    rng = np.random.default_rng(0)
    rows = []
    for model, (mean, std) in rs.TRANSFER_ANCHORS.items():
        values = rng.standard_normal(24)
        values = mean + 0.5 * std * (values - values.mean()) / values.std(
            ddof=1)
        rows += [(j, i, model, v, 0.0, 0.0) for j, i, v in zip(
            range(24), range(24), values)]
    got = rs.transfer_criteria(rows)
    assert got["hit"]
    assert got["stats"]["DPIVAE-B"][0] == pytest.approx(0.789)
    # DPIVAE-A above DPIVAE-B, within its own wide band: only the ranking
    # misses
    high = [(j, i, m, v + 0.2 if m == "DPIVAE-A" else v, 0.0, 0.0)
            for j, i, m, v, *_ in rows]
    got = rs.transfer_criteria(high)
    assert all(got["within"].values()) and not got["hit"]
    assert got["ranks_above"] == {"DPIVAE-A": False, "LIN": True,
                                  "MLP": True}
    # the MLP's mean outside its band
    off = [(j, i, m, v - 0.3 if m == "MLP" else v, 0.0, 0.0)
           for j, i, m, v, *_ in rows]
    got = rs.transfer_criteria(off)
    assert not got["within"]["MLP"] and not got["hit"]
