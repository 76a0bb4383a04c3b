#!/usr/bin/env python3
"""The port's results at the reference's full scale, held against the JAX
package's (``BASELINE.md``): each of the port's three programs run at its
defaults, its readings beside their anchors, each criterion hit or missed.

    python3 reference_scale.py anchors
    python3 reference_scale.py study
    python3 reference_scale.py transfer

``anchors`` runs ``dpivae_tpu_torch.scripts.single_run``'s ``main`` in
process for each row of BASELINE.md's "Quality anchors" (20,000
iterations, the preset's early stop) and each of ``SEEDS``, and records
the stop iteration, the final train and validation ELBO (the last logged
rows, as the programs print them), and the test y-R² of the VAE, LIN,
GPR and MLP per y dimension. Criterion per row: the mean over the seeds
of the VAE's R² is at least the anchor's less ``R2_MARGIN``, for each y
dimension, and the mean ELBO_val is within ``ELBO_TOL`` of the anchor's.

``study`` runs ``dpivae_tpu_torch.scripts.disentanglement_metric`` at its
defaults (damped_oscillator, 11 λ x 6 runs, 20,000 iterations, linear
probes on 2,048 + 2,048 points) and compares its scores with the JAX
package's committed ``benchmarks/results/disentanglement_score_oscillator.csv``
(the same study with the same least-squares probe) by the certification
criteria of BASELINE.md's probe section: each (λ, factor, latent block)
score averaged over the runs; where either package reads above
``SIGNAL``, the mean |difference| is at most ``SCORE_TOL``; the winning
block of each (λ, factor) agrees, except where both packages have the two
blocks within ``NEAR_TIE`` of each other.

``transfer`` runs ``dpivae_tpu_torch.scripts.regression_comparison`` at
its defaults (bridge, extrapolation, 6 runs x 4 domains x 2 VAEs, 20,000
iterations, scikit-learn's baselines). Criteria: each model's mean test
R² lies within the anchor's own mean ± std, and DPIVAE-B's mean ranks
above DPIVAE-A's, LIN's and MLP's.

Arguments after ``--`` go to the program unchanged (``--device cpu
--n_iter 50`` rehearses a subcommand on the CPU at a small size; the
criteria then mean nothing). Each subcommand prints its readings, writes
them with the criteria to ``--out`` (JSON, rewritten after every run of
``anchors``) and exits 1 when a criterion is missed. Programs' outputs go
under ``build/reference_scale/``. The card's name and power limit are
recorded beside the readings.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
R2_MARGIN = 0.03
ELBO_TOL = 0.15
SIGNAL = 0.2
SCORE_TOL = 0.1
NEAR_TIE = 0.12
SEEDS = (0, 1, 2)

# BASELINE.md "Quality anchors": the JAX package's single runs at the
# reference's defaults (20,000 iterations, patience 200), one run each.
ANCHORS = (
    dict(case="simple_beam", preset="dpivae", stop=12_971,
         elbo=(-1.006, -1.121), r2={"VAE": (0.986,), "LIN": (0.879,),
                                    "GPR": (0.988,), "MLP": (0.916,)}),
    dict(case="simple_beam", preset="vae", stop=9_671,
         elbo=(-1.913, -1.831), r2={"VAE": (0.992,), "LIN": (0.879,),
                                    "GPR": (0.988,), "MLP": (0.944,)}),
    dict(case="damped_oscillator", preset="dpivae", stop=12_131,
         elbo=(-1.498, -1.534), r2={"VAE": (0.976,), "LIN": (0.986,),
                                    "GPR": (0.999,), "MLP": (0.991,)}),
    dict(case="bridge", preset="dpivae", stop=8_191,
         elbo=(-5.292, -5.332), r2={"VAE": (0.977, 0.947),
                                    "LIN": (0.867, 0.877),
                                    "GPR": (0.970, 0.986),
                                    "MLP": (0.911, 0.838)}),
    dict(case="bridge", preset="vae", stop=20_000,
         elbo=(-6.221, -6.133), r2={"VAE": (0.977, 0.920),
                                    "LIN": (0.867, 0.877),
                                    "GPR": (0.970, 0.986),
                                    "MLP": (0.911, 0.838)}),
)
# BASELINE.md's transfer table (bridge, extrapolation, 24 folds): mean and
# std of the test y-R².
TRANSFER_ANCHORS = {"DPIVAE-B": (0.789, 0.101), "GPR": (0.826, 0.102),
                    "DPIVAE-A": (0.631, 0.232), "LIN": (0.632, 0.246),
                    "MLP": (0.443, 0.288)}
STUDY_REFERENCE = os.path.join(
    ROOT, "benchmarks", "results", "disentanglement_score_oscillator.csv")
BLOCKS = ("zx", "zc", "zy")


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _write(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def _mark(ok: bool) -> str:
    return "hit" if ok else "MISSED"


# ----------------------------------------------------------------------
# anchors


def anchor_criteria(anchor: dict, runs: List[dict]) -> dict:
    """The row's criterion over its runs: the mean VAE R² per y dimension
    against the anchor's less R2_MARGIN, the mean ELBO_val against the
    anchor's ± ELBO_TOL."""
    r2 = np.mean([r["r2"]["VAE"] for r in runs], axis=0)
    elbo_val = float(np.mean([r["elbo_val"] for r in runs]))
    floor = [a - R2_MARGIN for a in anchor["r2"]["VAE"]]
    r2_ok = bool(np.all(r2 >= np.asarray(floor)))
    elbo_ok = abs(elbo_val - anchor["elbo"][1]) <= ELBO_TOL
    return {"mean_r2_vae": r2.tolist(), "r2_floor": floor, "r2": r2_ok,
            "mean_elbo_val": elbo_val, "elbo_val_anchor": anchor["elbo"][1],
            "elbo_val": elbo_ok, "hit": r2_ok and elbo_ok}


def anchors(out: str, extra: Sequence[str]) -> bool:
    from dpivae_tpu_torch.scripts import single_run

    report = {"card": _card(), "program": single_run.MODULE,
              "extra_args": list(extra), "runs": [], "rows": []}
    for anchor in ANCHORS:
        runs = []
        for seed in SEEDS:
            name = f"{anchor['case']}_{anchor['preset']}_seed{seed}"
            t0 = time.perf_counter()
            run = single_run.main([
                "--case", anchor["case"], "--preset", anchor["preset"],
                "--seed", str(seed), "--name", name, "--output",
                os.path.join(ROOT, "build", "reference_scale", "anchors"),
                *extra])
            wall = time.perf_counter() - t0
            vae = run.config.name
            record = {
                "case": anchor["case"], "preset": anchor["preset"],
                "seed": seed, "n_iter": run.config.n_iter,
                "stop_iter": run.logs.stop_iter,
                "elbo_train": float(run.logs.scalars("ELBO")[1][-1]),
                "elbo_val": float(run.logs.scalars("ELBO_val")[1][-1]),
                "r2": {("VAE" if k == vae else k): np.asarray(
                    m["R2"], np.float64).reshape(-1).tolist()
                    for k, m in run.metrics.items()},
                "finite": bool(np.isfinite(
                    run.logs.train[run.logs.train_active].cpu().numpy()
                ).all()),
                "seconds": {**{k: round(v, 3)
                               for k, v in run.seconds.items()},
                            "wall": round(wall, 3)},
            }
            runs.append(record)
            report["runs"].append(record)
            print(f"reference_scale anchors: {name}: stop "
                  f"{record['stop_iter']} (anchor {anchor['stop']}), ELBO "
                  f"{record['elbo_train']:.4f} / {record['elbo_val']:.4f} "
                  f"(anchor {anchor['elbo'][0]} / {anchor['elbo'][1]}), "
                  f"R2 " + ", ".join(f"{k} {np.round(v, 4).tolist()}"
                                     for k, v in record["r2"].items())
                  + f"; {wall:.1f} s", flush=True)
            _write(out, report)
        crit = anchor_criteria(anchor, runs)
        report["rows"].append({**{k: anchor[k] for k in ("case", "preset")},
                               "anchor": anchor, **crit})
        print(f"reference_scale anchors: {anchor['case']} / "
              f"{anchor['preset']} over seeds {list(SEEDS)}: mean VAE R2 "
              f"{np.round(crit['mean_r2_vae'], 4).tolist()} against floor "
              f"{np.round(crit['r2_floor'], 3).tolist()} "
              f"{_mark(crit['r2'])}; mean ELBO_val "
              f"{crit['mean_elbo_val']:.4f} against {anchor['elbo'][1]} ± "
              f"{ELBO_TOL} {_mark(crit['elbo_val'])}", flush=True)
        _write(out, report)
    report["hit"] = all(r["hit"] for r in report["rows"])
    _write(out, report)
    return report["hit"]


# ----------------------------------------------------------------------
# study


def study_means(rows) -> Dict[tuple, float]:
    """(λ x 10^4 rounded, factor, block) -> the score averaged over the
    runs, from disentanglement_score.csv's rows (set, gen_factor, score,
    idx_var, iter, lambda)."""
    sums: Dict[tuple, list] = {}
    for block, factor, score, _, _, lam in rows:
        key = (round(float(lam), 3), factor, block)
        sums.setdefault(key, []).append(float(score))
    return {k: float(np.mean(v)) for k, v in sums.items()}


def study_criteria(port: Dict[tuple, float],
                   reference: Dict[tuple, float]) -> dict:
    """BASELINE.md's probe certification criteria between two tables of
    run-averaged scores."""
    if set(port) != set(reference):
        raise ValueError(f"score tables differ in their keys: "
                         f"{sorted(set(port) ^ set(reference))[:6]}")
    signal = [k for k in port if max(port[k], reference[k]) > SIGNAL]
    diffs = [abs(port[k] - reference[k]) for k in signal]
    mean_diff = float(np.mean(diffs)) if diffs else 0.0
    winners, flips, excused = 0, [], []
    for lam, factor in sorted({k[:2] for k in port}):
        p = {b: port[(lam, factor, b)] for b in BLOCKS}
        r = {b: reference[(lam, factor, b)] for b in BLOCKS}
        wp, wr = max(p, key=p.get), max(r, key=r.get)
        winners += 1
        if wp == wr:
            continue
        tie = (abs(p[wp] - p[wr]) <= NEAR_TIE
               and abs(r[wp] - r[wr]) <= NEAR_TIE)
        (excused if tie else flips).append(
            {"lambda_x1e4": lam, "factor": factor, "port": wp,
             "reference": wr, "port_scores": p, "reference_scores": r})
    return {"signal_keys": len(signal), "mean_abs_diff": mean_diff,
            "max_abs_diff": float(max(diffs)) if diffs else 0.0,
            "scores": mean_diff <= SCORE_TOL, "winners": winners,
            "winner_agree": winners - len(flips) - len(excused),
            "near_tie_flips": excused, "flips": flips,
            "winner": not flips,
            "hit": mean_diff <= SCORE_TOL and not flips}


def _read_scores(path: str) -> list:
    with open(path) as f:
        return [row for row in csv.reader(f)][1:]


def study(out: str, extra: Sequence[str]) -> bool:
    from dpivae_tpu_torch.scripts import disentanglement_metric

    t0 = time.perf_counter()
    result = disentanglement_metric.main([
        "--output", os.path.join(ROOT, "build", "reference_scale"),
        "--name", "study", *extra])
    wall = time.perf_counter() - t0
    port = study_means(result.rows)
    reference = study_means(_read_scores(STUDY_REFERENCE))
    crit = study_criteria(port, reference)
    stops = result.result.logs.train_active.sum(-1)
    report = {"card": _card(), "program": disentanglement_metric.MODULE,
              "extra_args": list(extra), "n_members": result.result.n_members,
              "n_iter": result.config.n_iter,
              "stop_iter": {"min": int(stops.min()),
                            "median": float(stops.float().median()),
                            "max": int(stops.max())},
              "probe_failures": result.failures,
              "timings": result.timings, "wall": round(wall, 3),
              "port_means": {"|".join(map(str, k)): v
                             for k, v in port.items()},
              "reference_means": {"|".join(map(str, k)): v
                                  for k, v in reference.items()},
              **crit}
    for lam, factor in sorted({k[:2] for k in port}):
        print(f"reference_scale study: λx1e4 {lam:>9} {factor:>6}: port "
              + " ".join(f"{b} {port[(lam, factor, b)]:.3f}" for b in BLOCKS)
              + " | JAX " + " ".join(
                  f"{b} {reference[(lam, factor, b)]:.3f}" for b in BLOCKS))
    print(f"reference_scale study: {crit['signal_keys']} scores above "
          f"{SIGNAL} in either package, mean |ΔR²| "
          f"{crit['mean_abs_diff']:.4f}"
          f" (max {crit['max_abs_diff']:.4f}) against {SCORE_TOL} "
          f"{_mark(crit['scores'])}; winning block agrees "
          f"{crit['winner_agree']}/{crit['winners']}, "
          f"{len(crit['near_tie_flips'])} near-tie flips, "
          f"{len(crit['flips'])} other flips {_mark(crit['winner'])}; "
          f"stop iterations {report['stop_iter']}; {wall:.1f} s")
    _write(out, report)
    return crit["hit"]


# ----------------------------------------------------------------------
# transfer


def transfer_criteria(rows) -> dict:
    """Each model's mean ± std R² over the folds (sample std), against
    TRANSFER_ANCHORS, and DPIVAE-B's rank."""
    by_model: Dict[str, list] = {}
    for _, _, model, r2, *_ in rows:
        by_model.setdefault(model, []).append(float(r2))
    stats = {m: (float(np.mean(v)), float(np.std(v, ddof=1)))
             for m, v in by_model.items()}
    within = {m: abs(stats[m][0] - mean) <= std
              for m, (mean, std) in TRANSFER_ANCHORS.items()}
    b = stats["DPIVAE-B"][0]
    ranks = {m: b > stats[m][0] for m in ("DPIVAE-A", "LIN", "MLP")}
    return {"stats": stats, "within": within, "ranks_above": ranks,
            "hit": all(within.values()) and all(ranks.values())}


def transfer(out: str, extra: Sequence[str]) -> bool:
    from dpivae_tpu_torch.scripts import regression_comparison

    t0 = time.perf_counter()
    result = regression_comparison.main([
        "--output", os.path.join(ROOT, "build", "reference_scale"),
        "--name", "transfer", *extra])
    wall = time.perf_counter() - t0
    crit = transfer_criteria(result.rows)
    stops = {p: r.logs.train_active.sum(-1).tolist()
             for p, r in result.results.items()}
    report = {"card": _card(), "program": regression_comparison.MODULE,
              "extra_args": list(extra), "n_iter": result.config.n_iter,
              "stop_iter": stops, "timings": result.timings,
              "wall": round(wall, 3), "rows": [list(r) for r in result.rows],
              **crit}
    for m, (mean, std) in TRANSFER_ANCHORS.items():
        got = crit["stats"][m]
        print(f"reference_scale transfer: {m:9s} R2 {got[0]:.3f} ± "
              f"{got[1]:.3f} against {mean} ± {std} "
              f"{_mark(crit['within'][m])}")
    print(f"reference_scale transfer: DPIVAE-B above "
          + ", ".join(f"{m} {_mark(ok)}"
                      for m, ok in crit["ranks_above"].items())
          + "; stop iterations per preset (median) "
          + ", ".join(f"{p} {float(np.median(s)):.0f}"
                      for p, s in stops.items()) + f"; {wall:.1f} s")
    _write(out, report)
    return crit["hit"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("what", choices=("anchors", "study", "transfer"))
    parser.add_argument("--out", default=None,
                        help="the JSON report (default: "
                             "build/reference_scale/<what>.json)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    out = args.out or os.path.join(ROOT, "build", "reference_scale",
                                   f"{args.what}.json")
    print(_card(), flush=True)
    if args.what == "anchors":
        hit = anchors(out, extra)
    elif args.what == "study":
        hit = study(out, extra)
    else:
        hit = transfer(out, extra)
    verdict = "all criteria hit" if hit else "a criterion MISSED"
    print(f"reference_scale {args.what}: {verdict}; report "
          f"{os.path.relpath(out, ROOT)}")
    return 0 if hit else 1


if __name__ == "__main__":
    sys.exit(main())
