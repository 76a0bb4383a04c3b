"""The port's example programs and its last small API pieces, on the CPU:

- ``examples.custom_case``: the cantilever physics against the JAX
  example's functions on the same factors (rtol/atol 1e-6, f32 on both
  sides), and the program in process;
- ``examples.hyper_search`` in process;
- ``examples.serve_http``: its server in a thread on port 0 over a saved
  artifact: ``/meta``, ``/predict`` equal to ``ServedPredictor`` called
  directly with the same seed (bit for bit: the same program on the same
  normals), 400 on bad widths and bad JSON, 404 elsewhere, and four
  concurrent requests equal to serial ones;
- ``train_model(progress=...)``: the narration equal, character for
  character, to JAX's ``make_progress_printer`` fed the port's own log
  rows, the "auto" rule, and the refusal with a mesh;
- ``utils.transforms.Flip`` / ``Identity`` and
  ``utils.priors.interp_ground_truth`` against JAX (exact), and
  ``utils.data.test_train_split``'s shapes.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu import cases as jax_cases
from dpivae_tpu.train.train import make_progress_printer as jax_printer
from dpivae_tpu.utils import transforms as jax_transforms
from dpivae_tpu.utils.priors import interp_ground_truth as jax_interp
from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch import cases as port_cases
from dpivae_tpu_torch.cases import get_case, list_cases
from dpivae_tpu_torch.examples import custom_case, hyper_search, serve_http
from dpivae_tpu_torch.serving import load_predictor, save_predictor
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.train.train import (
    build_train_fn,
    make_progress_printer,
    resolve_progress,
)
from dpivae_tpu_torch.utils import data as port_data
from dpivae_tpu_torch.utils import transforms
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.priors import interp_ground_truth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _jax_example(name):
    """The JAX package's example module ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------------
# custom_case and hyper_search
# ----------------------------------------------------------------------

def test_cantilever_physics_matches_jax(monkeypatch):
    # The JAX example registers its case when imported: into a copy of
    # the registry (the bundled three registered first), so that other
    # tests still see only those.
    jax_cases.list_cases()
    monkeypatch.setattr(jax_cases, "_REGISTRY", dict(jax_cases._REGISTRY))
    jax_case = _jax_example("custom_case")
    rng = np.random.default_rng(0)
    z = np.stack([rng.uniform(f.lb, f.ub, (5, 7)) for f in
                  custom_case.FACTORS], -1).astype(np.float32)
    for name in ("cantilever_tip_load", "full_response"):
        want = np.asarray(getattr(jax_case, name)(jnp.asarray(z)))
        got = getattr(custom_case, name)(torch.from_numpy(z))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)
    fields = lambda specs: [dataclasses.asdict(f) for f in specs]
    assert fields(custom_case.FACTORS) == fields(jax_case.FACTORS)
    assert fields(custom_case.PRIOR_X) == fields(jax_case.PRIOR_X)
    assert custom_case.PRESETS == jax_case.PRESETS


def test_custom_case_program(monkeypatch):
    # The program registers its case into a copy of the registry (the
    # bundled three registered first), so that other tests still see only
    # those.
    assert "cantilever" not in list_cases()
    monkeypatch.setattr(port_cases, "_REGISTRY", dict(port_cases._REGISTRY))
    run = custom_case.main(["--n_iter", "20", "--device", "cpu"])
    assert "cantilever" in list_cases()
    # Registering it again (a second run) is harmless
    custom_case.main(["--n_iter", "1", "--device", "cpu"])
    assert get_case("cantilever").name == "cantilever"
    _, elbo = run.logs.scalars("ELBO")
    assert len(elbo) == 20 and elbo[-1] < elbo[0]
    assert np.isfinite(run.metrics["cantilever"]["R2"]).all()
    assert len(run.rows) == 9
    assert all(np.isfinite(score) for _, _, score in run.rows)


def test_hyper_search_program(capsys):
    out = hyper_search.main(["--n_iter", "10", "--n_runs", "1", "--device",
                             "cpu"])
    assert out.result.n_members == 6 and out.final.shape == (6,)
    assert np.isfinite(out.final).all()
    assert sorted(out.order) == list(range(6))
    assert (np.diff(out.final[out.order]) >= 0).all()
    assert "hyper_search OK" in capsys.readouterr().out


# ----------------------------------------------------------------------
# serve_http
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=32, n_batch=16)
    gen = torch.Generator().manual_seed(0)
    data = sample_response(case, gen, 32, sample_dist=case.gt_dist(),
                           device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    path = save_predictor(
        str(tmp_path_factory.mktemp("serve") / "predictor.pt2"), model,
        params, cfg, case, n=8, outputs=("y", "xh_d"))
    served = load_predictor(path, device="cpu")
    server = serve_http.serve(served, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield served, url, data
    finally:
        server.shutdown()
        server.server_close()


def _request(url, body=None):
    """(status, decoded JSON) of a GET (``body`` None) or a POST."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _equal(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[name], np.float32), w,
                                      err_msg=name)


def test_serve_http_meta_and_predict(served):
    served, url, (x, c, _, _) = served
    status, meta = _request(url + "/meta")
    assert status == 200 and meta == served.meta
    x, c = x[:5].numpy(), c[:5].numpy()
    status, out = _request(url + "/predict",
                           {"x": x.tolist(), "c": c.tolist(), "seed": 3})
    assert status == 200
    _equal(out, served(x, c, seed=3))
    assert np.asarray(out["xh_d"]).shape == (5, 32)


@pytest.mark.parametrize("body, error", [
    ({"x": [[0.0] * 31], "c": [[0.0]]}, "x must be"),
    ({"x": [[0.0] * 32], "c": [[0.0, 1.0]]}, "c must be"),
    ({"x": [[0.0] * 32] * 2, "c": [[0.0]]}, "rows"),
    ({"x": [], "c": [[0.0]]}, "x must be"),
    ({"c": [[0.0]]}, "'x'"),
    ({"x": [[0.0] * 32], "c": [[0.0]], "seed": "a"}, "invalid literal"),
    (b"{not json", "Expecting"),
    ([1, 2], "JSON object"),
])
def test_serve_http_refuses_bad_requests(served, body, error):
    _, url, _ = served
    status, out = _request(url + "/predict", body)
    assert status == 400 and error in out["error"]
    assert _request(url + "/nowhere")[0] == 404
    assert _request(url + "/nowhere", {})[0] == 404


def test_serve_http_concurrent_requests_equal_serial(served):
    served, url, (x, c, _, _) = served
    bodies = [{"x": x[4 * i:4 * i + 4].tolist(),
               "c": c[4 * i:4 * i + 4].tolist(), "seed": i}
              for i in range(4)]
    serial = [_request(url + "/predict", b) for b in bodies]
    results = [None] * 4

    def post(i):
        results[i] = _request(url + "/predict", bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for (s_status, s_out), (c_status, c_out) in zip(serial, results):
        assert s_status == c_status == 200
        _equal(c_out, {k: np.asarray(v, np.float32)
                       for k, v in s_out.items()})


# ----------------------------------------------------------------------
# progress narration
# ----------------------------------------------------------------------

def _small_run(n_iter=30):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=32, n_val=16, n_batch=8, n_mc_train=2, n_mc_val=2,
        n_iter=n_iter, val_freq=10, use_seed=True)
    gen = torch.Generator().manual_seed(0)
    dtr, dva = (sample_response(case, gen, n, sample_dist=case.gt_dist(),
                                device="cpu") for n in (32, 16))
    return cfg, case, setup_model(cfg, case, dtr, device="cpu"), dtr, dva


def test_progress_lines_equal_jax():
    cfg, case, model, dtr, dva = _small_run()
    printer = make_progress_printer(cfg.n_iter, cfg.val_freq)
    calls = []

    def narrate(*args):
        calls.append(args)
        printer(*args)

    port_err = io.StringIO()
    with contextlib.redirect_stderr(port_err):
        _, logs = train_model(cfg, model, case, dtr, dva, device="cpu",
                              progress=narrate)
    assert [c[0] for c in calls] == [0, 10, 20]
    for block, (it, row, val_row, counter, active) in enumerate(calls):
        np.testing.assert_array_equal(row, logs.train[it].numpy())
        np.testing.assert_array_equal(val_row, logs.val[block].numpy())
        assert active is True and isinstance(counter, int)
    jax_err = io.StringIO()
    with contextlib.redirect_stderr(jax_err):
        narrate_jax = jax_printer(cfg.n_iter, cfg.val_freq)
        for args in calls:
            narrate_jax(*args)
    text = port_err.getvalue()
    assert text == jax_err.getvalue()
    assert text.count("\r") == 3 and text.endswith("\n")
    assert text.count("\n") == 1 and "ELBO_val=" in text
    # progress=True prints the same lines
    again = io.StringIO()
    with contextlib.redirect_stderr(again):
        train_model(cfg, model, case, dtr, dva, device="cpu", progress=True)
    assert again.getvalue() == text


def test_progress_auto_rule():
    cfg = TrainConfig()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    at = lambda n: cfg.replace(n_iter=n)
    assert resolve_progress("auto", at(5000), cpu, None) is True
    assert resolve_progress("auto", at(4999), cpu, None) is False
    assert resolve_progress("auto", at(20000), cuda, None) is False
    assert resolve_progress("auto", at(20000), cpu, object()) is False
    assert resolve_progress(True, at(10), cuda, None) is True
    assert resolve_progress(False, at(20000), cpu, None) is False
    # "auto" below 5000 steps on the CPU narrates nothing
    cfg, case, model, dtr, dva = _small_run(n_iter=10)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        train_model(cfg, model, case, dtr, dva, device="cpu")
    assert err.getvalue() == ""


def test_progress_with_mesh_raises():
    cfg, case, *_ = _small_run()
    for progress in (True, print):
        with pytest.raises(ValueError, match="mesh="):
            build_train_fn(cfg, case, mesh=object(), progress=progress)


# ----------------------------------------------------------------------
# transforms, priors, data
# ----------------------------------------------------------------------

def test_flip_and_identity_match_jax():
    z = np.random.default_rng(1).uniform(0.1, 0.9, (3, 4, 2)).astype(
        np.float32)
    lb, ub = np.array([2.0, 0.01], np.float32), np.array([6.0, 0.99],
                                                          np.float32)
    pairs = [
        (transforms.Flip(transforms.ShiftScale(torch.from_numpy(lb),
                                               torch.from_numpy(ub))),
         jax_transforms.Flip(jax_transforms.ShiftScale(jnp.asarray(lb),
                                                       jnp.asarray(ub)))),
        (transforms.Identity(), jax_transforms.Identity()),
    ]
    for port, ref in pairs:
        for way in ("forward", "inverse"):
            got = getattr(port, way)(torch.from_numpy(z))
            want = getattr(ref, way)(jnp.asarray(z))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{port} {way}")
                assert g.shape == w.shape


def test_interp_ground_truth_matches_jax():
    from dpivae_tpu.cases import get_case as jax_get_case

    for name in ("simple_beam", "damped_oscillator", "bridge"):
        assert (interp_ground_truth(get_case(name).factors)
                == jax_interp(jax_get_case(name).factors))


def test_test_train_split_shapes():
    a = np.arange(40, dtype=np.float32).reshape(20, 2)
    b = torch.arange(20.0)
    g = torch.Generator().manual_seed(0)
    a_tr, a_te, b_tr, b_te = port_data.test_train_split(12, 5, (a, b), g)
    assert a_tr.shape == (12, 2) and a_te.shape == (5, 2)
    assert b_tr.shape == (12,) and b_te.shape == (5,)
    assert isinstance(a_tr, np.ndarray) and isinstance(b_tr, torch.Tensor)
    # The arrays are split by the same rows, and no row is in both parts
    np.testing.assert_array_equal(a_tr[:, 0] / 2, b_tr.numpy())
    assert not set(b_tr.tolist()) & set(b_te.tolist())
    again = port_data.test_train_split(
        12, 5, (a, b), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again[0], a_tr)
    with pytest.raises(ValueError, match="exceeds"):
        port_data.test_train_split(16, 5, (a, b))
