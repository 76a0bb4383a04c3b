"""Back-to-back sweep jobs: ``train_sweep`` over the mix's members.

Each job is one call of ``dpivae_tpu_torch.sweep.train_sweep`` with its
own sweep seed, over λ = linspace(low, high, members), as the studies
call it: the members draw their data and weights from their generators,
then train member-batched (``MemberTrainer``: ``vmap(grad)`` and
``MemberAdam``), with one eager block, one capture and replays per chunk.
Set-up runs one sweep of the mix's ``change_steps`` steps, whose
parameters the check compares, then warms up with one short sweep at the
same shapes (its eager block, a capture and a replay). The window ends
with the job that is running when the seconds have passed.

The check takes members drawn from the seed (the first and the last λ
among them) of set-up's first sweep and of the window's first and last
job, works out each member's data and weights again from its generator in
the reference, follows its first steps, and compares them with the
member's logs; for set-up's first sweep also the member's parameters'
change over all its steps, leaf by leaf, from what ``train_sweep``
returns (``portbench/compare.py``). Over the 20 steps of a warm-up sweep
the rounding of adversarial members grows to the control's size
(PERF.md §6), so the change is compared after the first steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, compare
from portbench.drivers.train_jobs import kept_rows, run_window, watching
from portbench.reference import dpivae as ref


def setup(cfg, mix, seed, device):
    from dpivae_tpu_torch.sweep import train_sweep

    tc, case = common.train_config(cfg, n_iter=mix["n_iter"],
                                   patience=mix["patience"])
    lambdas = np.linspace(mix["lambda_low"], mix["lambda_high"],
                          mix["members"])
    state = dict(cfg=cfg, mix=mix, seed=seed, device=device, tc=tc,
                 case=case, lambdas=lambdas, members=mix["members"],
                 train_sweep=train_sweep)
    members = _checked(state)
    res = run_job(state, tc.replace(n_iter=change_steps(mix)), -2)
    state["first"] = (*kept_rows(res.logs, mix["check_steps"], tc.val_freq,
                                 members),
                      {k: v[members].clone() for k, v in res.params.items()})
    run_job(state, tc.replace(n_iter=mix["warm_iter"]), -1)
    common.sync(device)
    return state


def change_steps(mix) -> int:
    """The steps of the job whose parameters' change the check compares."""
    return mix["change_steps"]


def sweep_seed(seed: int, j: int) -> int:
    return common.derive(seed, 1, j & (2 ** 32 - 1))


def run_job(state, tc, j):
    return state["train_sweep"](tc, state["case"], state["lambdas"],
                                n_runs=1, seed=sweep_seed(state["seed"], j),
                                device=state["device"])


def _checked(state):
    """The members the check follows: the first and the last λ and
    ``check_members - 2`` more drawn from the seed."""
    m, k = state["mix"]["members"], state["mix"]["check_members"]
    rng = np.random.default_rng(common.derive(state["seed"], 3))
    inner = rng.choice(np.arange(1, m - 1), size=max(k - 2, 0), replace=False)
    return sorted({0, m - 1, *inner.tolist()})


def _jobs(state, seconds, rec):
    keep = state["mix"]["check_steps"]
    vf = state["tc"].val_freq
    members = _checked(state)
    deadline = None
    j = 0
    while True:
        t0 = time.perf_counter()
        if deadline is None:
            deadline = t0 + seconds
        try:
            with watching(state, rec, j, t0):
                logs = run_job(state, state["tc"], j).logs
            kept = kept_rows(logs, keep, vf, members)
            finite = bool(torch.isfinite(
                torch.where(logs.train_active[..., None], logs.train,
                            0.0)).all())
            common.sync(state["device"])
        except RuntimeError as exc:
            rec["errors"].append(repr(exc))
            kept, finite = None, False
        t1 = time.perf_counter()
        rec["spans"].append(("job", t0, t1,
                             state["tc"].n_iter * state["members"], finite))
        if kept is not None:
            rec["kept"][j] = kept
            for old in list(rec["kept"]):
                if 0 < old < j:
                    del rec["kept"][old]
        j += 1
        if t1 >= deadline:
            return


def window(state, seconds, traced):
    return run_window(state, seconds, traced, _jobs)


def end_to_end(rec):
    spans = rec["spans"]
    steps = sum(s[3] for s in spans)
    return {"train_member_steps_per_s": steps / (spans[-1][2] - spans[0][1])}


def check(state, rec, limits):
    cfg, mix, dev = state["cfg"], state["mix"], state["device"]
    common.release(state["device"])
    arrays = common.surrogate_arrays(cfg, dev)
    train, val, after = state["first"]
    jobs = [(-2, train, val, after)] + [
        (j, train, val, None) for j, (train, val) in sorted(rec["kept"].items())]
    readings = []
    for j, train, val, after in jobs:
        for row, m in enumerate(_checked(state)):
            g, data_train, data_val, weights, lam = _member(state, arrays,
                                                            j, m)
            readings.append(compare.compare_training(
                cfg, weights, data_train, data_val, g, lam, train[row],
                val[row], mix["check_steps"],
                None if after is None else {k: v[row] for k, v in
                                            after.items()},
                change_steps(mix)))
    return compare.verdict(readings, limits)


def _member(state, arrays, j, m):
    """Member m of job j worked out again from its generator: (the
    generator where its training draws start, data, weights, λ)."""
    cfg = state["cfg"]
    g = common.generator(state["device"], ref.member_seed(
        sweep_seed(state["seed"], j), m))
    data_train = ref.sample_response(cfg, arrays, g, cfg["n_train"])
    data_val = ref.sample_response(cfg, arrays, g, cfg["n_val"])
    weights = ref.seeded_init(cfg, g)
    return g, data_train, data_val, weights, float(np.float32(
        state["lambdas"][m]))


def runs(cfg, mix, seed, device):
    """The checked members of set-up's first sweep as (make_generator,
    weights, data, λ), for the control and the faults read against the
    reference."""
    state = dict(cfg=cfg, mix=mix, seed=seed, device=device,
                 lambdas=np.linspace(mix["lambda_low"], mix["lambda_high"],
                                     mix["members"]))
    arrays = common.surrogate_arrays(cfg, device)
    out = []
    for m in _checked(state):
        _, data_train, data_val, weights, lam = _member(state, arrays, -2, m)

        def make_g(m=m):
            return _member(state, arrays, -2, m)[0]

        out.append((make_g, weights, data_train, data_val, lam))
    return out


def control(cfg, mix, seed, device):
    """The control's readings: the reference in TF32 in the program's
    place, for the checked members of set-up's first sweep."""
    return compare.training_control(cfg, runs(cfg, mix, seed, device),
                                    mix["check_steps"], change_steps(mix))
