"""The port's device mesh (``dpivae_tpu_torch.parallel``) on the CPU: gloo
ranks spawned by ``torch.multiprocessing`` over a ``FileStore``, held
against JAX's 2-device ``sharded_train_step`` (the conftest's virtual CPU
devices) and against the port's own one-rank runs.

The ranks' work runs in top-level functions of this module, which imports
only torch, numpy and pytest at module level: a spawned rank imports it
afresh, without the conftest (which imports jax). JAX's side is computed
here in the parent; inputs and results pass through .npz files. Two
spawned groups in all: one of 2 ranks for every 1-D mesh and one of 4 for
the 2 x 2 mesh. Rank 0 also computes the unsharded references after the
sharded runs. Every rank, and this process during each test, runs torch
on one thread: the sizes are small, and the suite runs beside other
workers.

Tolerances: the sharded step against JAX as tests/test_torch_port_train.py
holds a train step (the loss rtol/atol 1e-4, params after three Adam steps
rtol/atol 1e-5); the data-parallel runs against the one-rank run with
tests/test_parallel.py's bounds (logs rtol 2e-4 / atol 1e-5, params rtol
5e-3 / atol 1e-5; the 2 x 2 sweep logs rtol 2e-3 / atol 1e-4): a sum over
ranks adds the rows' terms in another order. A member-sharded sweep trains
its members exactly as the unsharded one (a member's generator depends on
its id, not on its rank); the batched products of 2 members per call
against 3 may still sum in another order, so logs and params are held to
rtol/atol 1e-5 (the bridge P model too, with no carve-out for elements
near Adam's eps), and the predictions to 1e-6.
"""

import numpy as np
import pytest
import torch

B, N = 16, 4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
DP_LOG = dict(rtol=2e-4, atol=1e-5)
DP_PARAM = dict(rtol=5e-3, atol=1e-5)
MESH2D_LOG = dict(rtol=2e-3, atol=1e-4)
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)
SWEEP_CASES = (("simple_beam", "dpivae"), ("bridge", "DPIVAE-A"))
LOG_FIELDS = ("train", "val", "train_active", "val_active")


# ----------------------------------------------------------------------
# Configurations shared by the ranks and the parent
# ----------------------------------------------------------------------

def _step_config():
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case

    case = get_case("simple_beam")
    return case, TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=B, n_batch=B, n_mc_train=N, use_seed=True)


def _dp_config():
    """JAX's test_dp_full_training_matches_unsharded sizes."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case

    case = get_case("simple_beam")
    return case, TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=64, n_val=32, n_batch=16, n_mc_train=2, n_mc_val=4,
        n_iter=30, val_freq=10, use_seed=True)


def _sweep_config(case_name, preset):
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case

    case = get_case(case_name)
    return case, TrainConfig().with_preset(case.presets[preset]).replace(
        n_train=32, n_val=16, n_batch=16, n_mc_train=2, n_mc_val=4,
        n_mc_test=4, n_iter=20, val_freq=10, use_seed=True)


# An early stop at the dp sizes: a cyclical β_x (4 cycles, half of each a
# ramp) lifts the validation loss when β_x is back at 1, and patience 1
# with no dead zone latches the stop at block 5 of 8 (the loss rises from
# 1.016 to 1.046, a 3 % margin), so the loop ends after block 6.
DP_STOP = dict(n_iter=80, patience=1, min_delta=0.0,
               beta_x_annealing="cyclical", beta_x_n_cycles=4, beta_x_R=0.5)


def _dp_run(mesh=None, **over):
    """train_model at the dp sizes (with ``over`` in the config): data and
    init from seeded CPU generators, the same on every rank."""
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.utils.data import sample_response

    case, cfg = _dp_config()
    cfg = cfg.replace(**over)
    gen = torch.Generator().manual_seed(0)
    dtr = sample_response(case, gen, cfg.n_train, sample_dist=case.gt_dist(),
                          device="cpu")
    dva = sample_response(case, gen, cfg.n_val, sample_dist=case.gt_dist(),
                          device="cpu")
    model = setup_model(cfg, case, dtr, device="cpu")
    params = init_params(cfg, model, device="cpu")
    return train_model(cfg, model, case, dtr, dva, params=params,
                       device="cpu", mesh=mesh)


def _sweep_run(case_name, preset, lambdas, mesh=None):
    from dpivae_tpu_torch.sweep import train_sweep

    case, cfg = _sweep_config(case_name, preset)
    return train_sweep(cfg, case, lambdas, seed=17, mesh=mesh, device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sweep_arrays(prefix, result) -> dict:
    out = {f"{prefix}p:{k}": v.numpy() for k, v in result.params.items()}
    out.update({f"{prefix}log:{f}": getattr(result.logs, f).numpy()
                for f in LOG_FIELDS})
    return out


# ----------------------------------------------------------------------
# The ranks
# ----------------------------------------------------------------------

def _task_two_ranks(mesh_of, inputs, rank) -> dict:
    """Every 1-D mesh over 2 ranks: the sharded step from JAX's weights
    and normals, train_model over "dp", 3-member sweeps over "sweep" (one
    pad) and sweep_predict_y over "sweep"; then, on rank 0, the same runs
    without a mesh ("ref:")."""
    from dpivae_tpu_torch.parallel import sharded_train_step
    from dpivae_tpu_torch.sweep import member_datasets, sweep_predict_y
    from dpivae_tpu_torch.sweep.sweep import SweepResult
    from dpivae_tpu_torch.train import init_params, setup_model

    out = {}
    mesh = mesh_of(("dp",), None)
    case, cfg = _step_config()
    data = tuple(torch.from_numpy(inputs[k]) for k in ("x", "c", "y"))
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    params.load_state_dict({k[2:]: torch.from_numpy(inputs[k])
                            for k in inputs.files if k.startswith("w:")})
    step_fn, init_fn, place = sharded_train_step(cfg, model, case, mesh)
    params, batch = place(params, data)
    opt = init_fn(params)
    losses = []
    for eps in inputs["eps"]:
        params, opt, loss = step_fn(params, opt, {"z": eps}, batch,
                                    cfg.lambda_g0)
        losses.append(float(loss))
    out["step_loss"] = np.asarray(losses)
    out.update({f"step:{k}": v.numpy()
                for k, v in params.state_dict().items()})

    for prefix, over in (("dp:", {}), ("dps:", DP_STOP)):
        params, logs = _dp_run(mesh, **over)
        out.update({f"{prefix}p:{k}": v.numpy()
                    for k, v in params.state_dict().items()})
        out.update({f"{prefix}log:{f}": getattr(logs, f).numpy()
                    for f in LOG_FIELDS})

    mesh = mesh_of(("sweep",), None)
    results = {}
    for case_name, preset in SWEEP_CASES:
        res = results[case_name] = _sweep_run(case_name, preset,
                                              [1 / 256, -1.0, 0.5], mesh)
        out.update(_sweep_arrays(f"{case_name}:", res))

    # Four simple_beam members (the first twice), so that they divide over
    # 2 ranks.
    case, cfg = _sweep_config("simple_beam", "dpivae")
    res, pick = results["simple_beam"], [0, 1, 2, 0]
    res4 = SweepResult({k: v[pick] for k, v in res.params.items()}, None,
                       res.lambdas[pick], res.keys[pick], res.device)
    dtr = [member_datasets(cfg, case, k, "cpu")[0] for k in res4.keys]
    stack = lambda j: torch.stack([d[j] for d in dtr])
    x, c = stack(0)[:, :8], stack(1)[:, :8]
    predict = lambda m: sweep_predict_y(
        cfg, case, res4, tuple(stack(j) for j in range(3)), x, c, n=3,
        seed=5, mesh=m)
    out["y_mesh"] = predict(mesh).numpy()
    if rank == 0:
        out["y_ref"] = predict(None).numpy()
        for prefix, over in (("dp:", {}), ("dps:", DP_STOP)):
            params, logs = _dp_run(**over)
            out.update({f"ref:{prefix}p:{k}": v.numpy()
                        for k, v in params.state_dict().items()})
            out.update({f"ref:{prefix}log:{f}": getattr(logs, f).numpy()
                        for f in LOG_FIELDS})
        for case_name, preset in SWEEP_CASES:
            out.update(_sweep_arrays(f"ref:{case_name}:", _sweep_run(
                case_name, preset, [1 / 256, -1.0, 0.5])))
    return out


def _task_four_ranks(mesh_of, inputs, rank) -> dict:
    """A 2 x 2 ("sweep", "dp") mesh: members over one axis, each member's
    batches over the other; on rank 0 also the sweep without a mesh."""
    lambdas = [1 / 256, -1.0]
    out = _sweep_arrays("", _sweep_run("simple_beam", "dpivae", lambdas,
                                       mesh_of(("sweep", "dp"), (2, 2))))
    if rank == 0:
        out.update(_sweep_arrays("ref:", _sweep_run("simple_beam", "dpivae",
                                                    lambdas)))
    return out


def _rank(rank, world, store, task, inputs, out):
    import torch.distributed as dist

    from dpivae_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh_of = lambda axes, shape: make_mesh(world, axes, shape,
                                                device="cpu")
        result = globals()[task](mesh_of, np.load(inputs) if inputs else None,
                                 rank)
        np.savez(f"{out}{rank}.npz", **result)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, task, inputs=None) -> list:
    """Run ``task`` on ``world`` gloo ranks; each rank's result."""
    import torch.multiprocessing as mp

    path = None
    if inputs is not None:
        path = str(tmp_path / f"{task}_in.npz")
        np.savez(path, **inputs)
    out = str(tmp_path / f"{task}_rank")
    mp.spawn(_rank, args=(world, str(tmp_path / f"{task}_store"), task, path,
                          out), nprocs=world)
    return [dict(np.load(f"{out}{r}.npz")) for r in range(world)]


# ----------------------------------------------------------------------
# The parent: JAX's side and the one-rank references
# ----------------------------------------------------------------------

def _jax_setup():
    """simple_beam / "dpivae" in the JAX package at the step sizes, data
    from numpy, JAX-initialized weights, and the 3 steps' keys; returns
    (config, model, params, data, keys, inputs for the ranks: the data,
    the weights as a port state dict and each step's encoder normals)."""
    import jax
    import jax.numpy as jnp

    from dpivae_tpu.cases import get_case as jax_get_case
    from dpivae_tpu.config import TrainConfig as JaxTrainConfig
    from dpivae_tpu.train.setup import setup_model as jax_setup_model
    from dpivae_tpu.utils.priors import factor_indices
    from dpivae_tpu_torch.convert import state_dict_from_jax

    jcase = jax_get_case("simple_beam")
    rng = np.random.default_rng(0)
    z = np.stack([rng.uniform(f.args["low"], f.args["high"], B)
                  for f in jcase.factors], -1).astype(np.float32)
    noise = lambda d: 0.02 * rng.standard_normal((B, d)).astype(np.float32)
    x = (np.asarray(jcase.full_model(jnp.asarray(z))) + noise(jcase.nd_x))
    c = z[:, factor_indices(jcase.factors, "c")] + noise(jcase.nd_c)
    y = z[:, factor_indices(jcase.factors, "y")] + noise(jcase.nd_y)
    data = tuple(a.astype(np.float32) for a in (x, c, y))
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(
        n_train=B, n_batch=B, n_mc_train=N, use_seed=True)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    keys = [jax.random.PRNGKey(100 + step) for step in range(3)]
    # The encoder normals JAX's DPIVAE.loss draws from each step's key.
    eps = [np.asarray(jax.random.normal(jax.random.split(k)[0], (N, B, 6)))
           for k in keys]
    inputs = {"x": data[0], "c": data[1], "y": data[2], "eps": np.stack(eps)}
    inputs.update({f"w:{k}": v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jparams)).items()})
    return (jcfg, jcase, jmodel, jparams, data, keys), inputs


def _jax_sharded_steps(jcfg, jcase, jmodel, jparams, data, keys):
    """JAX's sharded_train_step over 2 virtual devices, one step a key;
    returns (losses, params after the steps as a port state dict)."""
    import jax

    from dpivae_tpu.parallel import make_mesh as jax_make_mesh
    from dpivae_tpu.parallel import sharded_train_step as jax_step
    from dpivae_tpu_torch.convert import state_dict_from_jax

    step_fn, init_fn, place = jax_step(jcfg, jmodel, jcase,
                                       jax_make_mesh(2, ("dp",)))
    p, batch = place(jparams, data)
    opt = init_fn(p)
    losses = []
    for key in keys:
        p, opt, loss = step_fn(p, opt, key, batch, float(jcfg.lambda_g0))
        losses.append(float(loss))
    want = {k: v.numpy() for k, v in
            state_dict_from_jax(jax.tree.map(np.asarray, p)).items()}
    return np.asarray(losses), want


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank group's results and JAX's steps, computed at once (the
    ranks need only JAX's inputs)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("two_ranks")
    jax_side, inputs = _jax_setup()
    with ThreadPoolExecutor(max_workers=1) as pool:
        spawned = pool.submit(_spawn, tmp, 2, "_task_two_ranks", inputs)
        losses, want = _jax_sharded_steps(*jax_side)
        ranks = spawned.result()
    return {"ranks": ranks, "jax_loss": losses, "jax_params": want}


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def _close_logs(ranks, prefix, **tol):
    """Every rank's logs under ``prefix`` against rank 0's reference."""
    for f in LOG_FIELDS:
        want = ranks[0][f"ref:{prefix}log:{f}"]
        for r in ranks:
            if want.dtype == bool:
                np.testing.assert_array_equal(r[f"{prefix}log:{f}"], want, f)
            else:
                _close(r[f"{prefix}log:{f}"], want, f, **tol)


def test_sharded_train_step_matches_jax(two_ranks):
    """The port's sharded_train_step over 2 gloo ranks against JAX's over
    2 virtual devices: 3 steps from the same weights and normals."""
    for r in two_ranks["ranks"]:
        _close(r["step_loss"], two_ranks["jax_loss"], "loss",
               rtol=LOSS_TOL, atol=LOSS_TOL)
        for name, w in two_ranks["jax_params"].items():
            _close(r[f"step:{name}"], w, name, rtol=PARAM_TOL,
                   atol=PARAM_TOL)


def test_dp_train_model_equals_unsharded(two_ranks):
    """train_model over a 2-rank "dp" mesh against the unsharded run: the
    same logs and params on both ranks, the early stop at the same
    block."""
    ranks = two_ranks["ranks"]
    _close_logs(ranks, "dp:", **DP_LOG)
    for key, want in ranks[0].items():
        if key.startswith("ref:dp:p:"):
            for r in ranks:
                _close(r[key[4:]], want, key, **DP_PARAM)


def test_dp_early_stop_equals_unsharded(two_ranks):
    """An early stop over the 2-rank "dp" mesh: both ranks read the same
    all-reduced validation loss, so both stop at the same block and end
    the loop at the same block after it, with logs and params equal bit
    for bit between them and to the unsharded run's within the dp run's
    bounds, its stop included."""
    ranks = two_ranks["ranks"]
    for key, value in ranks[0].items():
        if key.startswith("dps:"):
            np.testing.assert_array_equal(ranks[1][key], value, key)
    assert ranks[0]["dps:log:train_active"].sum() == 5 * 10 + 1
    _close_logs(ranks, "dps:", **DP_LOG)
    for key, want in ranks[0].items():
        if key.startswith("ref:dps:p:"):
            _close(ranks[0][key[4:]], want, key, **DP_PARAM)


def test_one_rank_mesh_equals_unsharded():
    """A one-rank mesh in this process (a gloo group over a HashStore):
    the sum over one rank is the identity, so the run equals the run
    without a mesh exactly."""
    from dpivae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device="cpu")
    try:
        assert mesh.backend == "gloo" and mesh.shape == {"dp": 1}
        got = _dp_run(mesh)
    finally:
        mesh.close()
    want = _dp_run()
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for (name, a), b in zip(got[0].state_dict().items(),
                            want[0].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("case_name,preset", SWEEP_CASES)
def test_sweep_member_mesh_equals_unsharded(two_ranks, case_name, preset):
    """3 members over a 2-rank "sweep" mesh (the last member padded onto
    rank 1 and dropped) against the unsharded sweep, member for member,
    on every rank: the S model and the P model."""
    ranks = two_ranks["ranks"]
    _close_logs(ranks, f"{case_name}:", **SHARD_TOL)
    refs = [k for k in ranks[0] if k.startswith(f"ref:{case_name}:p:")]
    assert refs
    for key in refs:
        for r in ranks:
            assert r[key[4:]].shape == ranks[0][key].shape
            _close(r[key[4:]], ranks[0][key], key, **SHARD_TOL)


def test_sweep_predict_y_mesh_equals_unsharded(two_ranks):
    """sweep_predict_y with the members split over 2 ranks and gathered,
    against the same call without a mesh."""
    ranks = two_ranks["ranks"]
    for r in ranks:
        assert r["y_mesh"].shape == (4, 8, 1)
        _close(r["y_mesh"], ranks[0]["y_ref"], rtol=1e-6, atol=1e-6)


def test_sweep_dp_product_mesh_matches_unsharded(tmp_path):
    """A 2 x 2 ("sweep", "dp") mesh over 4 ranks against the unsharded
    sweep, with tests/test_parallel.py's bounds."""
    ranks = _spawn(tmp_path, 4, "_task_four_ranks")
    _close_logs(ranks, "", **MESH2D_LOG)
    refs = [k for k in ranks[0] if k.startswith("ref:p:")]
    assert refs
    for key in refs:
        for r in ranks:
            _close(r[key[4:]], ranks[0][key], key, **DP_PARAM)


# ----------------------------------------------------------------------
# Refusals, without spawning
# ----------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    from dpivae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device="cpu")
    yield mesh
    mesh.close()


def test_dp_mesh_requires_divisible_batch():
    """JAX's message, without a group: the check reads the axis size."""
    from types import SimpleNamespace

    from dpivae_tpu_torch.train.train import build_train_fn

    case, cfg = _dp_config()
    mesh = SimpleNamespace(shape={"dp": 4})
    with pytest.raises(ValueError, match="divisible"):
        build_train_fn(cfg.replace(n_batch=10, n_val=32), case, mesh)
    with pytest.raises(ValueError, match="divisible"):
        build_train_fn(cfg.replace(n_batch=16, n_val=30), case, mesh)


def test_make_mesh_refusals(one_rank_mesh):
    """A world of the wrong size, shapes that do not cover the devices,
    and a gloo group for a CUDA mesh."""
    from dpivae_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="needs a job of 2 ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(1, axes=("sweep", "dp"), device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(1, axes=("sweep", "dp"), shape=(2, 1), device="cpu")
    mesh = make_mesh(1, axes=("sweep", "dp"), shape=(1, 1), device="cpu")
    assert mesh.shape == {"sweep": 1, "dp": 1}
    assert mesh.coords == {"sweep": 0, "dp": 0}


def test_make_mesh_needs_launcher_for_many(monkeypatch):
    """No group and no launcher: one device starts a one-rank group, more
    name the launch command."""
    import torch.distributed as dist

    from dpivae_tpu_torch.parallel import make_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()


def test_feed_process_local_and_shard_batch(one_rank_mesh):
    """One rank: feeding its rows gives them back, sharding keeps all."""
    from dpivae_tpu_torch.parallel import (
        feed_process_local,
        make_global_mesh,
        replicated,
        shard_batch,
    )

    a = torch.arange(12.0).reshape(6, 2)
    torch.testing.assert_close(feed_process_local(one_rank_mesh, a), a)
    got = shard_batch(one_rank_mesh, {"a": a, "b": (a[:, 0],)})
    torch.testing.assert_close(got["a"], a)
    torch.testing.assert_close(got["b"][0], a[:, 0])
    assert replicated(one_rank_mesh, [a])[0] is a
    mesh = make_global_mesh(("sweep", "dp"), (1, 1), device="cpu")
    assert mesh.shape == {"sweep": 1, "dp": 1}


@pytest.mark.parametrize("refused", ["checkpoint_dir", "chunk_callback"])
@pytest.mark.parametrize("trainer", ["train_sweep", "train_hyper_sweep",
                                     "train_sweep_data"])
def test_sweep_mesh_refuses_chunk_io(one_rank_mesh, tmp_path, trainer,
                                     refused):
    from dpivae_tpu_torch import sweep

    case, cfg = _sweep_config("simple_beam", "dpivae")
    kwargs = {"checkpoint_dir": str(tmp_path),
              "chunk_callback": lambda *a: None}
    data = tuple(np.zeros((2, 4, d), np.float32)
                 for d in (case.nd_x, case.nd_c, case.nd_y))
    args = {"train_sweep": ([0.1, 0.2],),
            "train_hyper_sweep": ({"lr_e": [1e-3, 2e-3]},),
            "train_sweep_data": ([0.1, 0.2], data, data)}[trainer]
    with pytest.raises(ValueError, match=refused):
        getattr(sweep, trainer)(cfg, case, *args, mesh=one_rank_mesh,
                                device="cpu", **{refused: kwargs[refused]})


def test_sweep_mesh_member_counts(one_rank_mesh):
    """The evaluators' and the data sweep's divisibility refusals, with
    JAX's messages, on a 2-member axis."""
    from types import SimpleNamespace

    from dpivae_tpu_torch.sweep import (
        sweep_disentanglement_latents,
        sweep_predict_y,
        train_sweep_data,
    )

    case, cfg = _sweep_config("simple_beam", "dpivae")
    mesh = SimpleNamespace(shape={"sweep": 2}, device=one_rank_mesh.device)
    result = SimpleNamespace(n_members=3, device="cpu")
    with pytest.raises(ValueError, match="n_members must be a multiple"):
        sweep_predict_y(cfg, case, result, (None,) * 3, None, None, mesh=mesh)
    with pytest.raises(ValueError, match="chunk_size must be a multiple"):
        sweep_disentanglement_latents(cfg, case, result, 4, 4, chunk_size=3,
                                      mesh=mesh)
    data = tuple(np.zeros((3, 4, d), np.float32)
                 for d in (case.nd_x, case.nd_c, case.nd_y))
    with pytest.raises(ValueError, match="pad members"):
        train_sweep_data(cfg, case, [0.1] * 3, data, data, mesh=mesh,
                         device="cpu")
