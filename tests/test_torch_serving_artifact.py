"""The port's serving artifact (``torch.export``) on the CPU: a saved and
loaded artifact against the JAX package's ``build_predict_fn`` under the
JAX package's own replayed normals, and against the port's live plain
``Predictor`` under the same seed, for the S model (simple_beam /
"dpivae") and the P model (bridge / "DPIVAE-A"), with ``cond`` False and
True, at batch 1 and 16 from one export; the plain export of a
``use_pallas`` model; the sidecar and the refusal of a foreign format;
``export_member_predictor``; ``single_run --export_serving``; and the
surrogate constants' cache when a model is exported before any eager call.

Small size (n = 8 MC samples) at the presets' full widths, the data and
weights of tests/test_torch_port_pmodel.py (numpy data, JAX-initialized
weights through ``params_from_jax``). Tolerances: against JAX rtol/atol
1e-4, as the live predictor is held (f32 on both sides, sums in other
orders); against the live plain predictor 1e-6 (the same operations, in
one program).
"""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from dpivae_tpu.serving import build_predict_fn as jax_build_predict_fn
from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import bridge as bridge_module
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.models import decoders
from dpivae_tpu_torch.scripts import single_run
from dpivae_tpu_torch.serving import (
    SAMPLE_SLOTS,
    Predictor,
    export_predictor,
    load_predictor,
    save_predictor,
)
from dpivae_tpu_torch.sweep import export_member_predictor, member_model
from dpivae_tpu_torch.sweep import train_sweep
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.utils.data import sample_response
from test_torch_port_pmodel import _data, _models, _replayed_noise

N = 8
RTOL = ATOL = 1e-4
LIVE_TOL = 1e-6
OUTPUTS = tuple(SAMPLE_SLOTS)
CONFIGS = [("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")]
_ids = [f"{c}-{p}" for c, p in CONFIGS]



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: under the suite's
    parallel workers the CPU is oversubscribed, and torch's per-op thread
    barriers then cost about a hundred times the work itself."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One export per (case, preset, cond), shared by the tests of this
    file: (JAX model triple, port model triple, loaded artifact)."""
    made = {}

    def get(case_name, preset, cond):
        key = (case_name, preset, cond)
        if key not in made:
            jax_side, (cfg, model, params) = _models(case_name, preset)
            path = save_predictor(
                str(tmp_path_factory.mktemp("art") / "predictor.pt2"), model,
                params, cfg, get_case(case_name), cond=cond, n=N,
                outputs=OUTPUTS)
            made[key] = (jax_side, (cfg, model, params),
                         load_predictor(path, device="cpu"), path)
        return made[key]

    return get


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_ids)
def test_artifact_matches_jax_predict_fn(artifacts, case_name, preset, cond):
    (jcfg, jmodel, jparams), (_, model, _), served, _ = artifacts(
        case_name, preset, cond)
    jpredict = jax_build_predict_fn(jmodel, jparams, jcfg, cond=cond, n=N,
                                    outputs=OUTPUTS)
    for batch, seed in ((1, 3), (16, 4)):
        x, c, _ = _data(case_name, batch, seed)
        key = jax.random.PRNGKey(seed)
        want = jpredict(np.asarray(jax.random.key_data(key), np.uint32), x, c)
        got = served(x, c, noise=_replayed_noise(key, model, N, batch, cond))
        assert tuple(got) == OUTPUTS
        for name, w in zip(OUTPUTS, want):
            assert got[name].shape == np.shape(w), name
            np.testing.assert_allclose(got[name], np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_ids)
def test_artifact_equals_live_predictor(artifacts, case_name, preset, cond):
    """Under the same seed the artifact draws the live predictor's normals
    (the P model's three encoder draws, z_prior, the observation noise
    of every slot) and answers as it does."""
    _, (cfg, model, params), served, _ = artifacts(case_name, preset, cond)
    live = Predictor(model, params, cfg, cond=cond, n=N, outputs=OUTPUTS,
                     device="cpu")
    for batch, seed in ((1, 0), (16, 5), (7, 5)):
        x, c, _ = _data(case_name, batch, seed)
        got, want = served(x, c, seed=seed), live(x, c, seed=seed)
        for name in OUTPUTS:
            np.testing.assert_allclose(got[name], want[name], rtol=LIVE_TOL,
                                       atol=LIVE_TOL, err_msg=name)
            assert not np.array_equal(got[name], served(x, c,
                                                        seed=seed + 1)[name])


def test_sidecar_records_the_contract_and_foreign_formats_are_refused(
        artifacts, tmp_path):
    _, (cfg, model, _), served, path = artifacts("bridge", "DPIVAE-A", True)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta == served.meta
    assert meta["format"] == "dpivae_tpu_torch.serving/1"
    assert meta["outputs"] == list(OUTPUTS) and meta["cond"] is True
    assert (meta["n_mc"], meta["nd_x"], meta["nd_c"]) == (N, 64, 2)
    assert meta["lambda_g0"] == cfg.lambda_g0
    assert [i["name"] for i in meta["inputs"]] == ["x", "c", "z", "z_prior",
                                                   "x", "c", "y"]
    assert meta["inputs"][0] == {"name": "x", "shape": ["b", 64],
                                 "dtype": "float32"}
    assert meta["inputs"][2]["shape"] == [N, "b", 10]
    # The P model's three encoder draws, then z_prior and the noise
    assert meta["draws"] == [["z", 2], ["z", 4], ["z", 4], ["z_prior", 4],
                             ["x", 64], ["c", 2], ["y", 2]]
    assert meta["devices"] == ["cpu", "cuda"]
    assert meta["torch_version"] == torch.__version__
    assert meta["config"]["model_type"] == "P"
    assert meta["case"] == "bridge"
    assert meta["case_fingerprint"] == get_case("bridge").fingerprint()

    foreign = tmp_path / "foreign.pt2"
    foreign.write_bytes(open(path, "rb").read())
    (tmp_path / "foreign.pt2.meta.json").write_text(json.dumps(
        {**meta, "format": "dpivae_tpu.serving/1"}))
    with pytest.raises(ValueError, match="not a dpivae_tpu_torch serving"):
        load_predictor(str(foreign), device="cpu")


def test_use_pallas_model_warns_once_and_exports_plain(monkeypatch):
    """The kernel cannot be traced: the export runs the plain decode (the
    kernel's wrapper is never called) and says so once."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=64, n_batch=16, use_pallas=True)
    data = sample_response(case, torch.Generator().manual_seed(0), 64,
                           sample_dist=case.gt_dist(), device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    assert model.use_pallas is True

    def refuse(*args, **kwargs):
        raise AssertionError("the export called the fused-MLP wrapper")

    monkeypatch.setattr(decoders, "fused_mlp", refuse)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        exported, meta = export_predictor(model, params, cfg, case, n=4,
                                          outputs=("xh_d", "y"))
    mine = [w for w in caught if "use_pallas=True" in str(w.message)]
    assert len(mine) == 1
    assert model.use_pallas is True  # the caller's model is untouched
    assert meta["config"]["use_pallas"] is True
    x, c = data[0][:5], data[1][:5]
    noise = {"z": torch.randn(4, 5, 6), "y": torch.randn(4, 5, 1)}
    got = exported.module()(x, c, noise["z"], noise["y"])
    plain = Predictor(dataclasses.replace(model, use_pallas=False), params,
                      cfg, n=4, outputs=("xh_d", "y"), device="cpu")
    want = plain._predict(x, c, noise=noise)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=LIVE_TOL, atol=LIVE_TOL)
        assert not g.requires_grad


def test_export_before_any_eager_call_leaves_the_model_eager():
    """A fresh bridge case whose partial-physics surrogate has decoded
    nothing: the export must not leave the tracer's tensors in its
    constants' cache, so the next eager call runs and equals a model that
    never was exported."""
    fresh = bridge_module.build.__wrapped__()
    cfg = TrainConfig().with_preset(fresh.presets["DPIVAE-A"]).replace(
        n_train=64, n_batch=16)
    data = sample_response(fresh, torch.Generator().manual_seed(0), 64,
                           sample_dist=fresh.gt_dist(), device="cpu")
    model = setup_model(cfg, fresh, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    assert not fresh.part_model._copies
    exported, _ = export_predictor(model, params, cfg, fresh, n=4,
                                   outputs=("xh_p",))
    assert not fresh.part_model._copies
    x, c = data[0][:3], data[1][:3]
    z = torch.randn(4, 3, 10, generator=torch.Generator().manual_seed(1))
    got = Predictor(model, params, cfg, n=4, outputs=("xh_p",),
                    device="cpu")._predict(x, c, noise={"z": z})[0]
    other = get_case("bridge")
    other_model = setup_model(cfg, other, data, device="cpu")
    want = Predictor(other_model, params, cfg, n=4, outputs=("xh_p",),
                     device="cpu")._predict(x, c, noise={"z": z})[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(exported.module()(x, c, z)[0], want,
                               rtol=LIVE_TOL, atol=LIVE_TOL)


def test_export_member_predictor_round_trips(tmp_path):
    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=64, n_val=32, n_batch=16, n_mc_train=4, n_mc_val=4,
        n_iter=5, val_freq=5, use_seed=True, n_mc_test=4)
    res = train_sweep(cfg, case, [0.5, -0.25], seed=2, device="cpu")
    path = export_member_predictor(cfg, case, res, 1,
                                   str(tmp_path / "member.pt2"),
                                   outputs=("y", "zx"), n=4)
    served = load_predictor(path, device="cpu")
    assert served.meta["lambda_g0"] == -0.25
    assert served.meta["case"] == "damped_oscillator"
    model, params = member_model(cfg, case, res, 1)
    live = Predictor(model, params, cfg, n=4, outputs=("y", "zx"),
                     device="cpu")
    x = torch.randn(6, case.nd_x, generator=torch.Generator().manual_seed(0))
    c = torch.rand(6, case.nd_c, generator=torch.Generator().manual_seed(1))
    got, want = served(x, c, seed=9), live(x, c, seed=9)
    for name in ("y", "zx"):
        np.testing.assert_allclose(got[name], want[name], rtol=LIVE_TOL,
                                   atol=LIVE_TOL)


def test_single_run_export_serving_writes_a_loadable_artifact(tmp_path):
    run = single_run.main([
        "--n_iter", "2", "--n_train", "64", "--n_val", "32", "--n_test",
        "16", "--device", "cpu", "--export_serving", "--output",
        str(tmp_path)])
    path = run.paths["predictor"]
    assert path == os.path.join(str(tmp_path), "single_run", "models",
                                "predictor.pt2")
    assert os.path.exists(path + ".meta.json")
    assert "export" in run.seconds
    served = load_predictor(path, device="cpu")
    assert served.outputs == ("y",) and served.meta["cond"] is False
    x, c = run.data_test[:2]
    got = served(x, c, seed=0)["y"]
    want = Predictor(run.model, run.params, run.config, device="cpu")(
        x, c, seed=0)["y"]
    np.testing.assert_allclose(got, want, rtol=LIVE_TOL, atol=LIVE_TOL)
