"""Back-to-back single-run training jobs: ``train_model`` at the preset.

Set-up makes the data and the weights from the seed on the card, builds
the model (scalers fitted on the training data) and warms up with one
short job at the same shapes (the kernels' build and load, the capture of
a block). The window then runs whole jobs, each from the same weights with
its own generator, as users call ``train_model``: each pays its eager
first block, its capture, its validations and the early-stop logic on the
device (``patience`` from the mix keeps the work fixed). The window ends
with the job that is running when the seconds have passed.

The check follows the first steps of the warm-up job and of the first
and the last job of the window in the plain reference, from the same
weights and data and with the same generator's draws, and compares the
first step's loss and sigma_x after every step; for the warm-up job,
whose steps are as many as the check follows, also the parameters'
change, leaf by leaf, from what ``train_model`` returns
(``portbench/compare.py``).
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import common, compare
from portbench.reference import dpivae as ref


def setup(cfg, mix, seed, device):
    from dpivae_tpu_torch.train import setup_model, train_model

    tc, case = common.train_config(cfg, n_iter=mix["n_iter"],
                                   patience=mix["patience"])
    data_train, data_val, weights = inputs(cfg, seed, device)
    model = setup_model(tc, case, data_train, device=device)
    params = model.init(torch.Generator(device=device), device=device)
    params.load_state_dict(weights, strict=True)
    state = dict(cfg=cfg, mix=mix, seed=seed, device=device, tc=tc,
                 case=case, model=model, params=params, weights=weights,
                 data_train=data_train, data_val=data_val,
                 train_model=train_model)
    params, logs = run_job(state, tc.replace(n_iter=mix["warm_iter"]), -1)
    state["warm"] = (*kept_rows(logs, mix["check_steps"], tc.val_freq),
                     {k: v.detach().clone()
                      for k, v in params.state_dict().items()})
    common.sync(device)
    return state


def kept_rows(logs, keep, val_freq, members=None):
    """The train rows of a job's first ``keep`` steps and the validations
    among them (of ``members`` where the logs have a member axis)."""
    train, val = logs.train, logs.val
    if members is not None:
        train, val = train[members], val[members]
    return (train[..., :keep, :].clone(),
            val[..., :-(-keep // val_freq), :].clone())


def inputs(cfg, seed, device):
    """The training and validation data and the weights, from the seed."""
    g = common.generator(device, common.derive(seed, 0))
    arrays = common.surrogate_arrays(cfg, device)
    data_train = ref.sample_response(cfg, arrays, g, cfg["n_train"])
    data_val = ref.sample_response(cfg, arrays, g, cfg["n_val"])
    return data_train, data_val, ref.bulk_params(cfg, g)


def job_seed(seed: int, j: int) -> int:
    return common.derive(seed, 1, j & (2 ** 32 - 1))


def run_job(state, tc, j):
    g = common.generator(state["device"], job_seed(state["seed"], j))
    return state["train_model"](
        tc, state["model"], state["case"], state["data_train"],
        state["data_val"], params=state["params"], generator=g,
        device=state["device"], progress=False)


def _jobs(state, seconds, rec):
    mix, tc = state["mix"], state["tc"]
    keep = mix["check_steps"]
    vf = tc.val_freq
    deadline = None
    j = 0
    while True:
        t0 = time.perf_counter()
        if deadline is None:
            deadline = t0 + seconds
        try:
            with watching(state, rec, j, t0):
                _, logs = run_job(state, tc, j)
            kept = kept_rows(logs, keep, vf)
            finite = bool(torch.isfinite(logs.train[:logs.stop_iter]).all())
            common.sync(state["device"])
        except RuntimeError as exc:
            rec["errors"].append(repr(exc))
            kept, finite = None, False
        t1 = time.perf_counter()
        rec["spans"].append(("job", t0, t1, tc.n_iter * state.get(
            "members", 1), finite))
        if kept is not None:
            rec["kept"][j] = kept
            for old in list(rec["kept"]):
                if 0 < old < j:
                    del rec["kept"][old]
        j += 1
        if t1 >= deadline:
            return


@contextlib.contextmanager
def watching(state, rec, j, t0):
    """In a traced run, the first job under a ``trace.ReplayWatch`` (the
    mix's ``trace_replays``); the job's fixed cost, from its start to its
    first replay, goes into ``rec``."""
    if state["tracer"] is None or j:
        yield
        return
    from portbench.trace import ReplayWatch

    watch = ReplayWatch(state["tracer"], *state["mix"]["trace_replays"])
    with watch:
        yield
    if watch.t_first is not None:
        rec["job_fixed_s"] = watch.t_first - t0


def run_window(state, seconds, traced, jobs):
    """Runs ``jobs(state, seconds, rec)``; with ``traced`` the first job
    carries a ``trace.Slice`` around some of its replayed blocks, which
    the job's own thread starts and stops (``trace.ReplayWatch``): Kineto
    hangs when it is stopped while another thread launches CUDA graphs,
    and slows the host several times over while it records an eager block
    or a capture."""
    from portbench import trace

    rec = {"spans": [], "kept": {}, "errors": []}
    state["tracer"] = trace.Slice() if traced else None
    jobs(state, seconds, rec)
    rec["attempted"] = len(rec["spans"])
    rec["failed"] = sum(1 for s in rec["spans"] if not s[4])
    tracer = state.pop("tracer")
    if tracer is not None:
        if tracer.events is None:
            raise RuntimeError("the traced job ended before its slice did")
        rec["slice"] = tracer.events
        rec["val_freq"] = state["tc"].val_freq
        rec["members"] = state.get("members", 1)
        rec["work"] = state["cfg"]
    return rec


def window(state, seconds, traced):
    return run_window(state, seconds, traced, _jobs)


def end_to_end(rec):
    spans = rec["spans"]
    steps = sum(s[3] for s in spans)
    return {"train_member_steps_per_s": steps / (spans[-1][2] - spans[0][1])}


def check(state, rec, limits):
    """Follows the warm-up job's steps and the first ``check_steps`` steps
    of the window's first and last job in the reference and compares them
    with the jobs' logs, and the warm-up job's leaves with the
    reference's."""
    cfg, mix = state["cfg"], state["mix"]
    for k in ("params", "model"):
        state.pop(k)
    common.release(state["device"])
    train, val, after = state["warm"]
    jobs = [(-1, train, val, after)] + [
        (j, train, val, None) for j, (train, val) in sorted(rec["kept"].items())]
    readings = []
    for j, train, val, after in jobs:
        g = common.generator(state["device"], job_seed(state["seed"], j))
        readings.append(compare.compare_training(
            cfg, state["weights"], state["data_train"], state["data_val"],
            g, cfg["lambda_g0"], train, val, mix["check_steps"], after,
            change_steps(mix)))
    return compare.verdict(readings, limits)


def change_steps(mix) -> int:
    """The steps of the job whose parameters' change the check compares:
    the warm-up job's."""
    return mix["warm_iter"]


def runs(cfg, mix, seed, device):
    """The warm-up job's inputs as (make_generator, weights, data, λ), for
    the control and the faults read against the reference."""
    data_train, data_val, weights = inputs(cfg, seed, device)
    make_g = lambda: common.generator(device, job_seed(seed, -1))
    return [(make_g, weights, data_train, data_val, cfg["lambda_g0"])]


def control(cfg, mix, seed, device):
    """The control's readings: the reference in TF32 in the program's
    place, for the warm-up job of this seed's run."""
    return compare.training_control(cfg, runs(cfg, mix, seed, device),
                                    mix["check_steps"], change_steps(mix))
