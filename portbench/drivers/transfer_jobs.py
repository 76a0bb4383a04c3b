"""Back-to-back transfer-study jobs: ``train_sweep_data`` over the mix's
members, as the bridge's regression comparison trains each preset.

Set-up draws every member's training and validation data once, as the
study draws them once for both presets: member m trains in the quadrant
domain m mod 4 (the study's extrapolation direction), its factors
uniform over the domain's box, the response from the case's full-physics
surrogate plus noise, each member from a generator of its own
(``portbench/reference/dpivae_p.py`` ``domain_response``). The datasets
stay on the card with a leading member axis, and every job is one call
``train_sweep_data(config, case, np.full(members, lambda_g0), data_train,
data_val, seed=<the job's>, chunk_size="auto", cuda_graph="auto")``: its
members draw their weights and training noise from generators of the
job's sweep seed, and train member-batched (``MemberTrainer``:
``vmap(grad)`` and ``MemberAdam``), one eager block, one capture and
replays a chunk. Set-up runs one job of the mix's ``change_steps`` steps,
whose parameters the check compares, then one short job at the same
shapes. The window ends with the job that is running when the seconds
have passed. A traced run also records the port's spans and counters
over the window (``dpivae_tpu_torch.utils.spans``) into ``rec["program"]``.

The check takes one member of each domain (the last member among them),
of set-up's first job and of the window's first and last job, works out
its weights again from its generator in the reference, follows its first
steps on its data, and compares them with the member's logs; for
set-up's first job also the member's parameters' change over its steps,
leaf by leaf, without Adam's near-zero elements (``change_gap``).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import common, compare
from portbench.drivers import sweep_jobs
from portbench.drivers.train_jobs import kept_rows, run_window, watching
from portbench.reference import dpivae as ref
from portbench.reference import dpivae_p as ref_p

sweep_seed = sweep_jobs.sweep_seed
end_to_end = sweep_jobs.end_to_end


def train_config(cfg, device, **overrides):
    """The program's ``TrainConfig`` and case of the configuration file,
    with ``overrides``, after checking that every size the file states is
    what the program runs."""
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.train.optim import MemberAdam, group_hparams
    from dpivae_tpu_torch.train.setup import make_template_model

    case = get_case(cfg["case"])
    tc = TrainConfig().with_preset(case.presets[cfg["preset"]]).replace(
        **overrides)
    model = make_template_model(tc, case, device=device)
    part = case.part_model.params["layers"]
    stated = {
        "model_type": (model.model_type, cfg["model_type"]),
        "nz_x": (model.nz_x, cfg["nz_x"]), "nz_c": (model.nz_c, cfg["nz_c"]),
        "nz_y": (model.nz_y, cfg["nz_y"]), "nd_x": (model.nd_x, cfg["nd_x"]),
        "nd_c": (model.nd_c, cfg["nd_c"]), "nd_y": (model.nd_y, cfg["nd_y"]),
        "idx_c_phys": (list(model.idx_c_phys), cfg["idx_c_phys"]),
        "encoder_hidden": (list(model.encoder_layers),
                           [cfg["encoder_hidden"]]),
        "encoder_arch": ([model.encoder_x_arch, model.encoder_c_arch,
                          model.encoder_y_arch], ["NN"] * 3),
        "prior_hidden": (list(model.prior_net_layers), [cfg["prior_hidden"]]),
        "decoder_aux_hidden": (list(model.decoder_aux_layers),
                               [cfg["decoder_aux_hidden"]]),
        "decoder_x_hidden": (model.decoder_x_hidden, cfg["decoder_x_hidden"]),
        "full_cov_prior": (model.full_cov_prior, False),
        "lambda_x": (model.lambda_x, None),
        "physics.layers": ([int(np.shape(part[0]["w"])[0])]
                           + [int(np.shape(layer["w"])[1])
                              for layer in part],
                           cfg["physics"]["layers"]),
        "lambda_g0": (tc.lambda_g0, cfg["lambda_g0"]),
        "hidden_width": (tc.hidden_width, None),
        "use_pallas": (tc.use_pallas, cfg["use_pallas"]),
        "compute_dtype": (tc.compute_dtype, None),
        "remat_decode": (tc.remat_decode, False),
        "clip_gradients": (tc.clip_gradients, False),
        "beta_x": (tc.beta_x0, cfg["beta_x"]),
        "prior_x": ([(p.name, p.lb, p.ub, p.dist, dict(p.args))
                     for p in case.prior_x],
                    [(p["name"], p["lb"], p["ub"], p["dist"],
                      {"low": p["low"], "high": p["high"]})
                     for p in cfg["prior_x"]]),
        "factors": ([(f.name, f.type, f.args["low"], f.args["high"])
                     for f in case.factors],
                    [(f["name"], f["type"], f["low"], f["high"])
                     for f in cfg["factors"]]),
        "adam.betas": (list(MemberAdam.BETAS), cfg["adam"]["betas"]),
        "adam.eps": (MemberAdam.EPS, cfg["adam"]["eps"]),
    }
    for prefix, mlp in (("", case.full_model), ("part_", case.part_model)):
        arrays = ref_p.load_arrays(cfg, "cpu", prefix)
        held = [a for layer in mlp.params["layers"]
                for a in (layer["w"], layer["b"])]
        held += [mlp.scaler_mean, mlp.scaler_scale]
        names = [f"{k}{i}" for i in range(len(held) // 2 - 1) for k in "wb"]
        stated[f"surrogate.{prefix or 'full'}"] = (
            all(np.array_equal(np.asarray(a, np.float32), arrays[n].numpy())
                for a, n in zip(held, names + ["scaler_mean",
                                               "scaler_scale"])), True)
    for key in ("n_train", "n_val", "n_batch", "n_mc_train", "n_mc_val",
                "n_mc_test", "val_freq", "alpha_x", "alpha_c", "alpha_y"):
        stated[key] = (getattr(tc, key), cfg[key])
    for key in ("sigma_x", "sigma_c", "sigma_y"):
        stated[key] = (getattr(case, key), cfg[key])
    for group, (lr, wd) in group_hparams(tc).items():
        stated[f"lr.{group}"] = (lr, cfg["adam"]["lr"].get(group))
        stated[f"wd.{group}"] = (wd, 0.0)
    for fld in ("lambda", "beta_x", "beta_c", "beta_y"):
        stated[f"{fld}_annealing"] = (getattr(tc, f"{fld}_annealing"), None)
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the program's configuration differs from "
                         f"{cfg['name']}.json: {wrong} (program, file)")
    return tc, case


def datasets(cfg, mix, seed, device):
    """Every member's (x, c, y) for training and validation, stacked on a
    leading member axis on ``device``: member m in domain m mod
    ``domains``, from its own generator."""
    arrays = ref_p.load_arrays(cfg, device)
    train, val = [], []
    for m in range(mix["members"]):
        g = common.generator(device, common.derive(seed, 0, m))
        domain = m % mix["domains"]
        train.append(ref_p.domain_response(cfg, arrays, g, cfg["n_train"],
                                           domain))
        val.append(ref_p.domain_response(cfg, arrays, g, cfg["n_val"],
                                         domain))
    stack = lambda sets: tuple(torch.stack([s[k] for s in sets])
                               for k in range(3))
    return stack(train), stack(val)


def setup(cfg, mix, seed, device):
    from dpivae_tpu_torch.sweep import train_sweep_data

    tc, case = train_config(cfg, device, n_iter=mix["n_iter"],
                            patience=mix["patience"])
    data_train, data_val = datasets(cfg, mix, seed, device)
    state = dict(cfg=cfg, mix=mix, seed=seed, device=device, tc=tc,
                 case=case, members=mix["members"],
                 lambdas=np.full(mix["members"], tc.lambda_g0, np.float32),
                 data_train=data_train, data_val=data_val,
                 train_sweep_data=train_sweep_data)
    members = checked(state)
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


def run_job(state, tc, j):
    return state["train_sweep_data"](
        tc, state["case"], state["lambdas"], state["data_train"],
        state["data_val"], seed=sweep_seed(state["seed"], j),
        chunk_size="auto", device=state["device"], cuda_graph="auto")


def checked(state):
    """The ``check_members`` members the check follows: one of each of
    the first domains, drawn from the seed, and the last member (of the
    last domain)."""
    mix = state["mix"]
    d, m = mix["domains"], mix["members"]
    rng = np.random.default_rng(common.derive(state["seed"], 3))
    runs = rng.integers(0, m // d, size=mix["check_members"] - 1)
    return sorted({int(r) * d + i for i, r in enumerate(runs)} | {m - 1})


def _jobs(state, seconds, rec):
    keep = state["mix"]["check_steps"]
    vf = state["tc"].val_freq
    members = checked(state)
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
    """The window's jobs; traced, under the port's span recording too,
    whose export goes into ``rec["program"]``."""
    if not traced:
        return run_window(state, seconds, False, _jobs)
    from dpivae_tpu_torch.utils import spans

    with spans.recording() as recording:
        rec = run_window(state, seconds, True, _jobs)
    rec["program"] = recording.export()
    return rec


# ----------------------------------------------------------------------
# The comparison
# ----------------------------------------------------------------------

def change_gap(start, after, followed: ref_p.Followed) -> float:
    """``compare.change_gap`` without Adam's near-zero elements: besides
    the leaves whose first gradient is under ``compare.DEAD_GRAD`` of the
    median leaf's, every element whose first gradient in the reference is
    under ``DEAD_GRAD`` of the median leaf's root mean square is left
    out. Adam moves such an element by about its learning rate, with the
    sign of a gradient that is nought to rounding."""
    dead = compare.DEAD_GRAD
    med_grad = statistics.median(followed.grad0.values())
    kept = [k for k in start if followed.grad0[k] >= dead * med_grad]
    floor = dead * statistics.median(
        followed.grad0[k] / max(followed.grad0_full[k].numel(), 1) ** 0.5
        for k in start)

    def norm(a, k):
        live = followed.grad0_full[k].abs().to(start[k].device) >= floor
        moved = a[k].double().to(start[k].device) - start[k].double()
        return float(torch.linalg.vector_norm(moved * live))

    want = {k: norm(followed.params, k) for k in kept}
    med = statistics.median(want.values())
    return max(abs(norm(after, k) - want[k]) / max(want[k], med)
               for k in kept)


def readings(cfg, followed, train_p, val_p, n_rows, start=None, after=None):
    """``compare.readings`` with this cell's ``change_gap``."""
    out = compare.readings(cfg, followed, train_p, val_p, n_rows)
    if after is not None:
        out["change_gap"] = change_gap(start, after, followed)
    return out


def compare_member(cfg, part, weights, data_train, data_val, g, lam,
                   train_p, val_p, n_rows, after=None, n_steps=None):
    """A member's logged rows against the reference over its first
    ``n_rows`` steps; with ``after``, its leaves after its ``n_steps``
    steps, the parameters' change too."""
    followed = ref_p.follow(cfg, part, weights, data_train, data_val, g, lam,
                            max(n_rows, n_steps or 0))
    rows = torch.cat([train_p[:n_rows, :8], train_p[:n_rows, 12:13]], 1)
    return readings(cfg, followed, rows, val_p, n_rows, weights, after)


def _member(state, j, m):
    """Member m of job j worked out again: (its generator where its
    training draws start, its weights, data, λ)."""
    cfg = state["cfg"]
    g = common.generator(state["device"], ref.member_seed(
        sweep_seed(state["seed"], j), m))
    weights = ref_p.seeded_init(cfg, g)
    data = tuple(tuple(a[m] for a in d) for d in (state["data_train"],
                                                  state["data_val"]))
    return g, weights, data, float(np.float32(state["lambdas"][m]))


def check(state, rec, limits):
    cfg, mix = state["cfg"], state["mix"]
    common.release(state["device"])
    part = ref_p.load_arrays(cfg, state["device"], "part_")
    train, val, after = state["first"]
    jobs = [(-2, train, val, after)] + [
        (j, train, val, None) for j, (train, val) in sorted(rec["kept"].items())]
    out = []
    for j, train, val, after in jobs:
        for row, m in enumerate(checked(state)):
            g, weights, (data_train, data_val), lam = _member(state, j, m)
            out.append(compare_member(
                cfg, part, weights, data_train, data_val, g, lam, train[row],
                val[row], mix["check_steps"],
                None if after is None else {k: v[row] for k, v in
                                            after.items()},
                change_steps(mix)))
    return compare.verdict(out, limits)


def runs(cfg, mix, seed, device):
    """The checked members of set-up's first job as (make_generator,
    weights, data_train, data_val, λ), for the control and the faults
    (``portbench/calibrate_transfer.py``)."""
    data_train, data_val = datasets(cfg, mix, seed, device)
    state = dict(cfg=cfg, mix=mix, seed=seed, device=device,
                 data_train=data_train, data_val=data_val,
                 lambdas=np.full(mix["members"], cfg["lambda_g0"],
                                 np.float32))
    out = []
    for m in checked(state):
        _, weights, (dtr, dva), lam = _member(state, -2, m)

        def make_g(m=m):
            return _member(state, -2, m)[0]

        out.append((make_g, weights, dtr, dva, lam))
    return out


def control(cfg, mix, seed, device):
    """The control's readings: the reference in TF32 in the program's
    place, for the checked members of set-up's first job."""
    part = ref_p.load_arrays(cfg, device, "part_")
    n = change_steps(mix)
    out = []
    for make_g, weights, dtr, dva, lam in runs(cfg, mix, seed, device):
        want = ref_p.follow(cfg, part, weights, dtr, dva, make_g(), lam, n)
        got = ref_p.follow(cfg, part, weights, dtr, dva, make_g(), lam, n,
                           tf32=True)
        out.append(readings(cfg, want, got.train, got.val,
                            mix["check_steps"], weights, got.params))
    return out
