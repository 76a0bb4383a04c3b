"""The port's sweep engine on the CPU, at small sizes (damped_oscillator /
dpivae, n_train 64, batch 16, 4 MC samples): members against the port's
own single runs (early stopping included), chunking, checkpoint resume and
its guards, the batched evaluation against per-member
``serving.sample_mean`` on the same noise, ``export_member``, and the
study script.

A member's result is held against ``train_model`` given the member's
datasets, init and generator (``member_datasets`` and
``member_generators``): each member draws from its own generator, so a
sweep member is a single run, batched. Logs after tens of Adam steps
agree to rtol/atol 1e-4 (batched and single matrix products sum in other
orders); chunkings of the same members to 1e-6 after a few steps.
"""

import csv
import functools
import json
import os

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.scripts import disentanglement_metric as study
from dpivae_tpu_torch.serving import sample_mean
from dpivae_tpu_torch.sweep import (
    clean_checkpoint_dir,
    export_member,
    member_datasets,
    member_model,
    sweep_disentanglement_latents,
    sweep_predict_y,
    sweep_sample,
    train_hyper_sweep,
    train_sweep,
    train_sweep_data,
)
from dpivae_tpu_torch.sweep.sweep import regressor_datasets
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train import train as train_mod
from dpivae_tpu_torch.train.checkpoint import load_model
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import member_generators

CASE = get_case("damped_oscillator")
TOL = 1e-4
CHUNK_TOL = 1e-6


def _cfg(**over):
    base = dict(n_train=64, n_val=32, n_batch=16, n_mc_train=4, n_mc_val=4,
                n_iter=20, val_freq=10, use_pallas=True, use_seed=True,
                patience=10**9, n_mc_test=8)
    return TrainConfig().with_preset(CASE.presets["dpivae"]).replace(
        **{**base, **over})


def _single_run(cfg, key):
    """The member of ``key`` as a single ``train_model`` run: its data and
    init from its generator, then training on the same generator."""
    g = member_generators(int(key[0]), [int(key[1])], "cpu")[0]
    data_train, data_val = member_datasets(cfg, CASE, None, generator=g)
    params = make_template_model(cfg, CASE, device="cpu").init(g,
                                                               device="cpu")
    model = setup_model(cfg, CASE, data_train, device="cpu")
    return train_model(cfg, model, CASE, data_train, data_val, params=params,
                       generator=g, device="cpu")


def _count_steps(monkeypatch):
    """Count MemberTrainer.step calls: the batched training steps."""
    calls = [0]
    step = train_mod.MemberTrainer.step

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return step(self, *args, **kwargs)

    monkeypatch.setattr(train_mod.MemberTrainer, "step", counted)
    return calls


def test_members_equal_single_runs_with_early_stops():
    """patience 0, a one-sample validation and a 10x learning rate for one
    member: members stop at different blocks (at iterations 21 and 11 with
    these seeds; the CPU run is deterministic) and one runs to the end.
    Each equals its own single run: a stopped member's params are those
    right after its stopping block's first step (the single run's break),
    its later rows NaN and inactive, while the others keep training."""
    lrs = [0.01, 1e-4, 3e-4]
    cfg = _cfg(n_iter=60, n_mc_val=1, patience=0, min_delta=0.0)
    grid = {f: lrs for f in ("lr_e", "lr_dx", "lr_p", "lr_dc", "lr_dy")}
    res = train_hyper_sweep(cfg, CASE, grid, seed=3, chunk_size=None,
                            device="cpu")
    stops = res.logs.train_active.sum(1).tolist()
    assert stops == [21, 11, 60]
    for m in range(3):
        one = cfg.replace(**res.member_overrides(m),
                          lambda_g0=float(res.lambdas[m]))
        params, logs = _single_run(one, res.keys[m])
        got = res.member_logs(m)
        assert torch.equal(got.train_active, logs.train_active)
        assert torch.equal(got.val_active, logs.val_active)
        torch.testing.assert_close(got.train, logs.train, rtol=TOL, atol=TOL,
                                   equal_nan=True)
        torch.testing.assert_close(got.val, logs.val, rtol=TOL, atol=TOL,
                                   equal_nan=True)
        for name, p in params.state_dict().items():
            torch.testing.assert_close(res.params[name][m], p, rtol=TOL,
                                       atol=TOL)


def test_chunk_size_one_equals_one_chunk():
    cfg = _cfg(n_iter=5, val_freq=5)
    lambdas = [0.5, -0.5, 1 / 128]
    whole = train_sweep(cfg, CASE, lambdas, seed=2, chunk_size=None,
                        device="cpu")
    ones = train_sweep(cfg, CASE, lambdas, seed=2, chunk_size=1,
                       device="cpu")
    assert whole.logs.train.shape == (3, 5, 13)
    np.testing.assert_array_equal(whole.keys, ones.keys)
    for name in whole.params:
        torch.testing.assert_close(ones.params[name], whole.params[name],
                                   rtol=CHUNK_TOL, atol=CHUNK_TOL)
    torch.testing.assert_close(ones.logs.train, whole.logs.train,
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)


def test_auto_and_plain_agree_and_members_differ():
    """use_pallas "auto" resolves to the plain path in a sweep; on the CPU
    use_pallas=True runs the same plain arithmetic through the vmap rules,
    so the two sweeps agree. Members differ (own data, init, λ)."""
    lambdas = [1.0, -1.0]
    runs = [train_sweep(_cfg(use_pallas=p), CASE, lambdas, seed=4,
                        device="cpu") for p in ("auto", True)]
    torch.testing.assert_close(runs[0].logs.train, runs[1].logs.train,
                               rtol=CHUNK_TOL, atol=CHUNK_TOL)
    train = runs[1].logs.train
    assert torch.isfinite(train).all()
    assert not torch.allclose(train[0], train[1])


def _files(path):
    return sorted(f for f in os.listdir(path) if f.startswith("chunk_"))


def test_checkpoint_resume_is_identical(tmp_path, monkeypatch):
    cfg = _cfg(n_iter=10)
    ckpt = str(tmp_path / "chunks")
    lambdas = [1 / 256, 0.0, -1.0]
    first = train_sweep(cfg, CASE, lambdas, seed=11, chunk_size=2,
                        checkpoint_dir=ckpt, device="cpu")
    files = _files(ckpt)
    assert [f[:6] + f[19:] for f in files] == ["chunk_000000.npz",
                                                "chunk_000002.npz"]
    steps = _count_steps(monkeypatch)
    seen = []
    again = train_sweep(cfg, CASE, lambdas, seed=11, chunk_size=2,
                        checkpoint_dir=ckpt, device="cpu",
                        chunk_callback=lambda s, p, l: seen.append(
                            (s, l.train.shape[0])))
    assert steps[0] == 0, "a resumed sweep trains nothing"
    assert seen == [(0, 2), (2, 1)]
    for name in first.params:
        assert torch.equal(first.params[name], again.params[name])
    for a, b in zip(first.logs, again.logs):
        assert torch.equal(a, b)


def test_checkpoint_foreign_grid_is_not_resumed(tmp_path):
    cfg = _cfg(n_iter=10)
    ckpt = str(tmp_path / "chunks")
    grid_a, grid_b = [0.5, -0.5], [0.05, -0.9]
    res_a = train_sweep(cfg, CASE, grid_a, seed=13, chunk_size=1,
                        checkpoint_dir=ckpt, device="cpu")
    res_b = train_sweep(cfg, CASE, grid_b, seed=13, chunk_size=1,
                        checkpoint_dir=ckpt, device="cpu")
    fresh_b = train_sweep(cfg, CASE, grid_b, seed=13, chunk_size=1,
                          device="cpu")
    for name in res_b.params:
        assert torch.equal(res_b.params[name], fresh_b.params[name])
    assert not torch.allclose(res_a.logs.train, res_b.logs.train)
    assert len(_files(ckpt)) == 4  # both sweeps' chunks stay


def test_checkpoint_stale_chunk_size_recomputes(tmp_path, monkeypatch):
    """Chunks written under another chunk size belong to another sweep
    identity (the digest covers the chunk size): the rerun recomputes and
    equals a fresh run."""
    cfg = _cfg(n_iter=5, val_freq=5)
    ckpt = str(tmp_path / "chunks")
    lambdas = [0.1, -0.2, 0.4, -0.6]
    train_sweep(cfg, CASE, lambdas, seed=5, chunk_size=3,
                checkpoint_dir=ckpt, device="cpu")
    steps = _count_steps(monkeypatch)
    res = train_sweep(cfg, CASE, lambdas, seed=5, chunk_size=2,
                      checkpoint_dir=ckpt, device="cpu")
    assert steps[0] == 2 * cfg.n_iter
    fresh = train_sweep(cfg, CASE, lambdas, seed=5, chunk_size=2,
                        device="cpu")
    for name in res.params:
        torch.testing.assert_close(res.params[name], fresh.params[name],
                                   rtol=0, atol=CHUNK_TOL)


def test_checkpoint_gc_keeps_registered_sweeps(tmp_path, monkeypatch):
    """gc_stale_chunks deletes an unregistered sweep's chunks, never other
    files (a digest-less chunk name included), and every registered sweep
    stays resumable."""
    cfg = _cfg(n_iter=5, val_freq=5)
    ckpt = str(tmp_path / "shared")
    lam_a, lam_b = [1 / 256, 0.0], [0.5, -0.5]
    train_sweep(cfg, CASE, lam_a, seed=11, chunk_size=1, checkpoint_dir=ckpt,
                device="cpu")
    res_b = train_sweep(cfg, CASE, lam_b, seed=11, chunk_size=1,
                        checkpoint_dir=ckpt, device="cpu")
    for name in ("chunk_deadbeef0123_000000.npz", "chunk_000000.npz"):
        np.savez(os.path.join(ckpt, name), x=np.zeros(3))
    with open(os.path.join(ckpt, "notes.txt"), "w") as f:
        f.write("keep me")
    steps = _count_steps(monkeypatch)
    train_sweep(cfg, CASE, lam_a, seed=11, chunk_size=1, checkpoint_dir=ckpt,
                device="cpu", gc_stale_chunks=True)
    files = set(os.listdir(ckpt))
    assert "chunk_deadbeef0123_000000.npz" not in files
    assert {"chunk_000000.npz", "notes.txt"} <= files
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert len(json.load(f)["history"]) == 2
    again_b = train_sweep(cfg, CASE, lam_b, seed=11, chunk_size=1,
                          checkpoint_dir=ckpt, device="cpu")
    assert steps[0] == 0, "both registered sweeps resume"
    assert torch.equal(again_b.logs.train, res_b.logs.train)
    assert clean_checkpoint_dir(ckpt, keep=[])
    assert _files(ckpt) == ["chunk_000000.npz"]
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train_sweep(cfg, CASE, lam_a, device="cpu", gc_stale_chunks=True)


def test_auto_chunk_size_from_free_memory(monkeypatch):
    """Members per chunk: half the free memory over member_bytes, at least
    one, at most all."""
    from dpivae_tpu_torch.sweep import sweep as sweep_mod

    cfg = _cfg()
    per = sweep_mod.member_bytes(cfg, CASE)
    assert per > 0
    for free, want in ((2 * 10 * per, 10), (per, 1), (2 * 100 * per, 66)):
        monkeypatch.setattr(sweep_mod, "_free_bytes", lambda _, f=free: f)
        assert sweep_mod.auto_chunk_size(66, cfg, CASE, "cpu") == want


def test_data_sweep_and_guards():
    cfg = _cfg(n_iter=10)
    g = torch.Generator().manual_seed(0)
    data = [member_datasets(cfg, CASE, None, generator=g) for _ in range(2)]
    stack = lambda k: tuple(torch.stack([d[k][i] for d in data])
                            for i in range(3))
    res = train_sweep_data(cfg, CASE, [0.1, -0.1], stack(0), stack(1),
                           seed=1, device="cpu")
    assert res.logs.train.shape == (2, 10, 13)
    assert torch.isfinite(res.logs.train).all()
    with pytest.raises(ValueError, match="member axis"):
        train_sweep_data(cfg, CASE, [0.1], stack(0), stack(1), device="cpu")
    # A mesh has no chunk stream (the mesh itself is tested in
    # tests/test_torch_parallel.py).
    with pytest.raises(ValueError, match="chunk_callback"):
        train_sweep(cfg, CASE, [0.1], mesh=object(),
                    chunk_callback=lambda *a: None, device="cpu")
    with pytest.raises(ValueError, match="cannot be swept"):
        train_hyper_sweep(cfg, CASE, {"n_iter": [1]}, device="cpu")


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg(n_iter=20)
    return cfg, train_sweep(cfg, CASE, [0.5, -0.5, 0.0], seed=9,
                            device="cpu")


def test_sweep_predict_y_and_sample_match_sample_mean(trained):
    cfg, res = trained
    m_count, n, batch = res.n_members, 8, 10
    g = torch.Generator().manual_seed(1)
    models = [member_model(cfg, CASE, res, m) for m in range(m_count)]
    data = [member_datasets(cfg, CASE, k, "cpu")[0] for k in res.keys]
    dtr = tuple(torch.stack([d[i] for d in data]) for i in range(3))
    x, c = dtr[0][:, :batch], dtr[1][:, :batch]
    noise = {"z": torch.randn(m_count, n, batch, 9, generator=g),
             "y": torch.randn(m_count, n, batch, 1, generator=g)}
    got = sweep_predict_y(cfg, CASE, res, dtr, x, c, n=n, noise=noise)
    assert got.shape == (m_count, batch, 1)
    for m, (model, params) in enumerate(models):
        (want,) = sample_mean(model, params, x[m], c[m], outputs=("y",), n=n,
                              grl_alpha=cfg.lambda_g0,
                              noise={k: v[m] for k, v in noise.items()})
        torch.testing.assert_close(got[m], want, rtol=1e-5, atol=1e-6)
    full = sweep_sample(cfg, CASE, res, dtr, x, c, n=2, seed=3)
    assert len(full) == 9 and full[0].shape == (m_count, 2, batch, CASE.nd_x)
    assert all(torch.isfinite(t).all() for t in full)


def test_sweep_latents_match_sample_mean(trained):
    cfg, res = trained
    n_tr, n_te = 40, 30
    g = torch.Generator().manual_seed(2)
    noise = tuple({"z": torch.randn(res.n_members, 1, n, 9, generator=g)}
                  for n in (n_tr, n_te))
    got = sweep_disentanglement_latents(cfg, CASE, res, n_tr, n_te, seed=1,
                                        chunk_size=2, noise=noise)
    assert got["zx_train"].shape == (res.n_members, n_tr, 1)
    gens = member_generators(1, range(res.n_members), "cpu")
    for m in range(res.n_members):
        model, params = member_model(cfg, CASE, res, m)
        splits = regressor_datasets(CASE, gens[m], n_tr, n_te)
        for name, data, eps in zip(("train", "test"), splits, noise):
            want = sample_mean(model, params, data[0], data[1],
                               outputs=("zx", "zc", "zy"), n=1,
                               grl_alpha=cfg.lambda_g0,
                               noise={"z": eps["z"][m]})
            for block, w in zip(("zx", "zc", "zy"), want):
                torch.testing.assert_close(got[f"{block}_{name}"][m], w,
                                           rtol=1e-5, atol=1e-6)
            assert torch.equal(got[f"z_{name}"][m], data[3])
    drawn = sweep_disentanglement_latents(cfg, CASE, res, n_tr, n_te)
    assert all(torch.isfinite(v).all() for v in drawn.values())


def test_export_member_round_trip(trained, tmp_path):
    cfg, res = trained
    path = str(tmp_path / "member1")
    model, params = export_member(cfg, CASE, res.host(), 1, path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["sweep_member"] == 1 and meta["lambda"] == -0.5
    loaded_model, loaded = load_model(path, CASE, device="cpu")
    for name, p in params.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], p)
        assert torch.equal(p, res.params[name][1])
    x = torch.zeros(3, CASE.nd_x)
    torch.testing.assert_close(loaded_model.transform_x.forward(x)[0],
                               model.transform_x.forward(x)[0])


def test_study_script_on_cpu(tmp_path, monkeypatch):
    """2 λ x 1 run, 20 iterations: its files and columns, and a rerun into
    the same output that resumes every chunk (no training step) and writes
    the same scores."""
    argv = ["--lambdas", "0.0001", "-0.0001", "--n_runs", "1", "--n_iter",
            "20", "--device", "cpu", "--output", str(tmp_path),
            "--n_train_regressor", "200", "--n_test_regressor", "200"]
    first = study.main(argv)
    out = tmp_path / "disentanglement"
    assert first.path == str(out)
    for name in ("args.json", "disentanglement_score.csv", "timings.json",
                 "chunks/manifest.json", "0/metrics/train.csv",
                 "1/metrics/ELBO_val.csv"):
        assert (out / name).exists(), name
    with open(out / "disentanglement_score.csv") as f:
        rows = list(csv.reader(f))
    assert tuple(rows[0]) == study.SCORE_COLUMNS
    assert len(rows) - 1 == 2 * len(CASE.factors) * 3
    assert {r[0] for r in rows[1:]} == {"zx", "zc", "zy"}
    assert all(np.isfinite(float(r[2])) for r in rows[1:])
    assert sorted({float(r[5]) for r in rows[1:]}) == pytest.approx(
        [-1.0, 1.0])
    with open(out / "timings.json") as f:
        assert {"train", "latents", "probes", "total"} <= set(json.load(f))
    steps = _count_steps(monkeypatch)
    second = study.main(argv)
    assert steps[0] == 0
    assert second.rows == first.rows
    with pytest.raises(SystemExit):
        study.main(argv + ["--n_devices", "2"])


@pytest.fixture(scope="module")
def study_linear(tmp_path_factory):
    """One study of 2 λ x 1 run, 20 iterations, with linear probes: its
    argv (without --regressor) and its score rows."""
    argv = ["--lambdas", "0.0001", "-0.0001", "--n_runs", "1", "--n_iter",
            "20", "--device", "cpu", "--n_train_regressor", "200",
            "--n_test_regressor", "200", "--output",
            str(tmp_path_factory.mktemp("study"))]
    return argv, study.main(argv + ["--regressor", "linear"]).rows


@pytest.mark.parametrize("regressor", ["linear_jax", "mlp_jax", "mlp"])
def test_study_script_regressor_names(regressor, study_linear, monkeypatch):
    """The JAX script's other --regressor names, each resuming the linear
    study's chunks (no training step): linear_jax writes the linear
    scores; mlp_jax (--probe_epochs 5) and mlp (scikit-learn's fit, its
    max_iter cut to 30 here) write finite scores of every probe."""
    from dpivae_tpu_torch.eval import probes

    monkeypatch.setattr(probes, "fit_mlp_probes_sklearn", functools.partial(
        probes.fit_mlp_probes_sklearn, max_iter=30))
    argv, linear_rows = study_linear
    steps = _count_steps(monkeypatch)
    run = study.main(argv + ["--regressor", regressor, "--probe_epochs", "5"])
    assert steps[0] == 0
    assert [r[:2] + r[3:] for r in run.rows] == [
        r[:2] + r[3:] for r in linear_rows]
    if regressor == "linear_jax":
        assert run.rows == linear_rows
    else:
        assert all(np.isfinite(r[2]) for r in run.rows)
        assert run.rows != linear_rows
