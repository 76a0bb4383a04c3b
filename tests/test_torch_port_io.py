"""The port's single-run program and what it writes, against the JAX package
where it has a counterpart, on the CPU: the metric CSVs, checkpoints and
servable models, the case fingerprint, the template model, the scaler
converter, the resolution of ``use_pallas="auto"``, and the single-run CLI
end to end with ``--device cpu``.

Tolerances: the CSVs parse to exactly the JAX writer's doubles; a model
saved and restored predicts exactly what it did before, and a converted
JAX model restored by the port predicts what JAX's ``load_model`` does to
1e-5 (f32 on both sides, x in mm up to about 25; tests/test_torch_port_
model.py holds the same predictions to 1e-4 at n = 8 over 16 points; here
3 samples of 8 points).
"""

import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.train import checkpoint as jax_checkpoint
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.train.train import TrainLogs as JaxTrainLogs
from dpivae_tpu.utils.logging import save_logs_csv as jax_save_logs_csv
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, scalers_from_jax
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.scripts import single_run
from dpivae_tpu_torch.serving import Predictor
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_checkpoint_config,
    load_model,
    save_checkpoint,
    save_model,
)
from dpivae_tpu_torch.train.setup import (
    make_template_model,
    resolve_use_pallas,
)
from dpivae_tpu_torch.train.train import TRAIN_COLUMNS, VAL_COLUMNS, TrainLogs
from dpivae_tpu_torch.utils.logging import (
    get_logger_training_curve,
    load_series_csv,
    save_logs_csv,
)
from test_torch_port_model import _data, _replayed_noise

N_TRAIN, B = 64, 16


def _logs(seed, n_iter=25, n_blocks=3, stop=22):
    """The same f32 logs as the JAX package's and the port's TrainLogs:
    values over many magnitudes, zeros and an integral float, an early
    stop at ``stop``."""
    rng = np.random.default_rng(seed)
    train = (rng.standard_normal((n_iter, len(TRAIN_COLUMNS)))
             * 10.0 ** rng.integers(-9, 9, (n_iter, len(TRAIN_COLUMNS)))
             ).astype(np.float32)
    train[3, 2], train[5, 1], train[4, 5] = 0.0, 12345678.0, 1e-30
    train[stop:] = np.nan
    val = rng.standard_normal((n_blocks, len(VAL_COLUMNS))).astype(np.float32)
    t_active = np.arange(n_iter) < stop
    v_active = np.arange(n_blocks) < n_blocks
    v_iters = np.arange(n_blocks) * 10
    jax_logs = JaxTrainLogs(jnp.asarray(train), jnp.asarray(val),
                            jnp.asarray(t_active), jnp.asarray(v_active),
                            jnp.asarray(v_iters, jnp.int32))
    port_logs = TrainLogs(*(torch.from_numpy(a) for a in (
        train, val, t_active, v_active, v_iters)))
    return jax_logs, port_logs


def test_csvs_parse_to_the_jax_writers_doubles(tmp_path):
    jax_logs, port_logs = _logs(0)
    jax_save_logs_csv(jax_logs, str(tmp_path / "jax"))
    save_logs_csv(port_logs, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert set(names) == {f"{n}.csv" for n in (
        "train", "val", *TRAIN_COLUMNS, *VAL_COLUMNS)}
    for name in names:
        header = lambda d: (tmp_path / d / name).read_text().splitlines()[0]
        assert header("port") == header("jax"), name
        load = lambda d: np.loadtxt(tmp_path / d / name, delimiter=",",
                                    skiprows=1, ndmin=2)
        np.testing.assert_array_equal(load("port"), load("jax"), err_msg=name)
    iters, vals = load_series_csv(str(tmp_path / "port"), "ELBO")
    want_iters, want_vals = get_logger_training_curve(port_logs, "ELBO")
    np.testing.assert_array_equal(iters, want_iters)
    assert len(iters) == 22  # the active rows only
    np.testing.assert_array_equal(vals.astype(np.float32), want_vals)


def _train(**over):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=N_TRAIN, n_val=32, n_batch=B, n_iter=20, val_freq=10,
        n_mc_train=2, n_mc_val=2, use_seed=True, **over)
    data_train, data_val = _data(N_TRAIN, 0), _data(32, 1)
    model = setup_model(cfg, case, data_train, device="cpu")
    params, logs = train_model(cfg, model, case, data_train, data_val,
                               device="cpu")
    return case, cfg, model, params, logs


def test_checkpoint_round_trip(tmp_path):
    case, cfg, model, params, _ = _train()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, config=cfg)
    state = load_checkpoint(path)
    for name, value in params.state_dict().items():
        assert torch.equal(state[name], value), name
    restored = load_checkpoint(path, like=model.init(
        torch.Generator().manual_seed(5), device="cpu"))
    for name, value in params.state_dict().items():
        assert torch.equal(restored.state_dict()[name], value), name
    assert load_checkpoint_config(path) == cfg


def test_saved_model_predicts_as_before(tmp_path):
    case, cfg, model, params, _ = _train()
    path = str(tmp_path / "model")
    save_model(path, model, params, cfg, case=case)
    model2, params2 = load_model(path, case, device="cpu")
    for name in ("transform_x", "transform_c", "transform_y"):
        for field in ("mean", "scale"):
            assert torch.equal(getattr(getattr(model2, name), field),
                               getattr(getattr(model, name), field))
    x, c, _ = _data(8, 7)
    outputs = ("y", "x_sample", "zx")
    want = Predictor(model, params, cfg, n=3, outputs=outputs,
                     device="cpu")(x, c, seed=3)
    got = Predictor(model2, params2, cfg, n=3, outputs=outputs,
                    device="cpu")(x, c, seed=3)
    for name in outputs:
        np.testing.assert_array_equal(got[name], want[name])
    assert load_checkpoint_config(path) == cfg


def test_converted_jax_model_restores_as_jax_does(tmp_path):
    """A JAX model (its params and fitted scalers) crosses to the port by
    ``params_from_jax`` and ``scalers_from_jax``; saved and restored by the
    port, it predicts what the JAX package's own save_model/load_model
    round trip predicts, on replayed noise."""
    over = dict(n_train=N_TRAIN, n_batch=B, use_seed=True)
    data = _data(N_TRAIN, 0)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jax_checkpoint.save_model(str(tmp_path / "jax"), jmodel, jparams, jcfg,
                              case=jcase)
    jmodel2, jparams2 = jax_checkpoint.load_model(str(tmp_path / "jax"), jcase)

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    template = make_template_model(cfg, case, device="cpu")
    model = dataclasses.replace(template,
                                **scalers_from_jax(jmodel, device="cpu"))
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    save_model(str(tmp_path / "port"), model, params, cfg, case=case)
    model2, params2 = load_model(str(tmp_path / "port"), case, device="cpu")

    x, c, _ = _data(8, 2)
    key = jax.random.PRNGKey(11)
    want = jmodel2.sample(jparams2, key, jnp.asarray(x), jnp.asarray(c), n=3,
                          grl_alpha=jcfg.lambda_g0)
    with torch.no_grad():
        got = model2.sample(params2, torch.from_numpy(x), torch.from_numpy(c),
                            n=3, grl_alpha=cfg.lambda_g0,
                            noise=_replayed_noise(key, jmodel2, 3, 8, False))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_load_model_warns_on_a_changed_case(tmp_path):
    case, cfg, model, params, _ = _train()
    path = str(tmp_path / "model")
    save_model(path, model, params, cfg, case=case)
    changed = dataclasses.replace(case, sigma_x=float(case.sigma_x) * 2.0)
    with pytest.warns(UserWarning, match="fingerprint"):
        load_model(path, changed, device="cpu")


def test_case_fingerprint_follows_the_content():
    case = get_case("bridge")
    before = case.fingerprint()
    assert before == dataclasses.replace(case).fingerprint()
    # Using the frozen physics on a device fills its per-device copies,
    # which the digest leaves out.
    case.part_model(torch.zeros(2, 3))
    assert dataclasses.replace(case).fingerprint() == before
    assert dataclasses.replace(case, sigma_x=1.0).fingerprint() != before
    prior = dataclasses.replace(case.prior_x[0], ub=case.prior_x[0].ub + 1)
    assert dataclasses.replace(
        case, prior_x=(prior, *case.prior_x[1:])).fingerprint() != before
    names = {get_case(n).fingerprint() for n in
             ("simple_beam", "damped_oscillator", "bridge")}
    assert len(names) == 3


def test_template_model_refuses_to_run():
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=N_TRAIN, n_batch=B)
    template = make_template_model(cfg, case, device="cpu")
    params = template.init(torch.Generator().manual_seed(0), device="cpu")
    x, c, _ = _data(4, 0)
    with pytest.raises(RuntimeError, match="template model"):
        template.sample(params, torch.from_numpy(x), torch.from_numpy(c),
                        n=2, generator=torch.Generator())


def test_scalers_from_jax_carry_the_fitted_scalers():
    data = _data(N_TRAIN, 0)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(
        n_train=N_TRAIN, n_batch=B)
    jmodel = jax_setup_model(jcfg, jcase, data)
    scalers = scalers_from_jax(jmodel, device="cpu")
    assert set(scalers) == {"transform_x", "transform_c", "transform_y"}
    for name, scaler in scalers.items():
        np.testing.assert_array_equal(scaler.mean.numpy(),
                                      np.asarray(getattr(jmodel, name).mean))
        np.testing.assert_array_equal(scaler.scale.numpy(),
                                      np.asarray(getattr(jmodel, name).scale))


# ---------------------------------------------------------------------------
# use_pallas="auto"


def _config(**over):
    case = get_case("simple_beam")
    return case, TrainConfig().with_preset(case.presets["dpivae"]).replace(
        **over)


@pytest.fixture
def card(monkeypatch):
    """Pretend that CUDA devices are of the card named ``card.name``."""

    class Card:
        name = ops._AUTO_DEVICE_NAME

    monkeypatch.setattr(ops, "_device_name", lambda device: Card.name)
    monkeypatch.setattr(ops, "_warned_device_names", set())
    return Card


@pytest.mark.parametrize("over, resolved", [
    (dict(), True),                                   # 64 x 16 = 1,024 rows
    (dict(mc_chunk=2), False),                        # 64 x 2 rows a chunk
    (dict(n_mc_train=32, mc_chunk=16), True),         # 64 x 16 rows a chunk
    (dict(n_batch=16, n_mc_train=16), False),         # 256 rows, under 1,000
    (dict(hidden_width=512), False),                  # H outside {128, 256}
    (dict(hidden_width=256, n_mc_train=64), True),    # 4,096 x (4 -> 256)
    (dict(nz_c=10, nz_y=10), False),                  # d_in 20 over 16
    (dict(compute_dtype="bfloat16"), False),          # the kernel is f32
    (dict(use_pallas=True, mc_chunk=2), True),        # explicit choices
    (dict(use_pallas=False), False),                  # pass through
], ids=["main-path", "chunk-2", "chunk-16", "few-rows", "wide", "h256",
        "d_in-20", "bf16", "true", "false"])
def test_auto_resolution_on_the_card(card, over, resolved):
    """The band: 1,000 to 262,144 rows of the training shape (per chunk
    when the loss's decode is chunked), d_in up to 16, H 128 or 256, d_out
    32 or 64 (simple_beam's 32 here); bf16 keeps plain PyTorch."""
    case, cfg = _config(**over)
    mc_chunk = None if cfg.mc_chunk == "auto" else cfg.mc_chunk
    hidden = cfg.hidden_width or 128
    assert resolve_use_pallas(cfg, case, mc_chunk, hidden,
                              torch.device("cuda")) is resolved


def test_auto_on_another_card_warns_once(card):
    case, cfg = _config()
    card.name = "NVIDIA A100-SXM4-80GB"
    with pytest.warns(UserWarning, match="A100"):
        assert resolve_use_pallas(cfg, case, None, 128,
                                  torch.device("cuda")) is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_use_pallas(cfg, case, None, 128,
                                  torch.device("cuda")) is False


def test_auto_on_the_cpu_is_plain():
    case, cfg = _config(n_train=N_TRAIN, n_batch=B)
    assert cfg.use_pallas == "auto"
    assert resolve_use_pallas(cfg, case, None, 128, torch.device("cpu")) \
        is False
    assert setup_model(cfg, case, _data(N_TRAIN, 0),
                       device="cpu").use_pallas is False


# ---------------------------------------------------------------------------
# The single-run CLI


def test_single_run_cli_on_the_cpu(tmp_path):
    args = ["--device", "cpu", "--n_iter", "20", "--n_train", "64",
            "--n_val", "32", "--n_test", "32", "--seed", "3", "--name", "t",
            "--output", str(tmp_path)]
    run = single_run.main(args)
    out = tmp_path / "t"
    assert sorted(os.listdir(out)) == ["metrics", "models", "settings"]
    assert TrainConfig.from_json(str(out / "settings" / "args.json")) == \
        run.config
    assert run.config.name == "t" and run.config.n_iter == 20
    assert run.model.use_pallas is False  # "auto" on the CPU
    metrics = sorted(os.listdir(out / "metrics"))
    assert "train.csv" in metrics and "val.csv" in metrics
    assert len(metrics) == 2 + len(TRAIN_COLUMNS) + len(VAL_COLUMNS)
    train = np.loadtxt(out / "metrics" / "train.csv", delimiter=",",
                       skiprows=1, ndmin=2)
    assert train.shape == (20, 1 + len(TRAIN_COLUMNS))
    assert np.isfinite(train).all()
    assert set(run.metrics) == {"LIN", "GPR", "MLP", "t"}
    for m in run.metrics.values():
        for name in ("R2", "MSE", "MAE"):
            assert m[name].shape == (1,) and np.isfinite(m[name]).all()
    assert set(run.seconds) == {"train", "csv", "save", "LIN", "GPR", "MLP",
                                "evaluate"}
    model, params = load_model(str(out / "models" / "model"), run.case,
                               device="cpu")
    x, c = run.data_test[0][:8], run.data_test[1][:8]
    want = Predictor(run.model, run.params, run.config, n=4,
                     device="cpu")(x, c, seed=1)
    got = Predictor(model, params, run.config, n=4, device="cpu")(x, c,
                                                                  seed=1)
    np.testing.assert_array_equal(got["y"], want["y"])
    # Seeded: a second run draws the same data and trains the same way.
    again = single_run.main(args)
    assert torch.equal(again.logs.train, run.logs.train)


@pytest.mark.parametrize("flag, item", [
    # --n_devices above 1 needs the launcher (the id is the one the case
    # has always had, from when the mesh was not ported).
    pytest.param(["--n_devices", "2"], "torch.distributed.run --standalone",
                 id="flag0-item 11"),
    # --plots is refused where seaborn does not import, as on the card's
    # host (the id is the one the case has always had).
    pytest.param(["--plots"], "--plots needs seaborn", id="flag1-item 10"),
    (["--preset", "nope"], "unknown preset"),
])
def test_single_run_cli_refuses_what_is_not_ported(flag, item, capsys,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "seaborn", None)
    with pytest.raises(SystemExit):
        single_run.main(["--device", "cpu", *flag])
    assert item in capsys.readouterr().err
