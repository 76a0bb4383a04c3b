"""The span recorder (``dpivae_tpu_torch.utils.spans``) on the CPU: off,
it records nothing and makes no CUDA event; on, a ``train_model`` call
and a ``train_sweep`` call record their spans under the right parents and
one job id, a call inside an open job joins it, and the params and logs
are the same bit for bit with recording on and off. Small sizes (n_train
64, batch 16, 4 MC samples), so the file runs in seconds."""

import threading

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.sweep import train_sweep
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils import spans
from dpivae_tpu_torch.utils.data import sample_response

SMALL = dict(n_train=64, n_val=32, n_batch=16, n_mc_train=4, n_mc_val=4,
             val_freq=10, use_seed=True, patience=10**9)


def _cfg(case, n_iter):
    return TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_iter=n_iter, **SMALL)


@pytest.fixture(scope="module")
def beam():
    case = get_case("simple_beam")
    cfg = _cfg(case, 30)
    g = torch.Generator().manual_seed(0)
    data_train = sample_response(case, g, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cpu")
    data_val = sample_response(case, g, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cpu")
    model = setup_model(cfg, case, data_train, device="cpu")
    params = init_params(cfg, model, device="cpu")

    def run():
        return train_model(cfg, model, case, data_train, data_val,
                           params=params, device="cpu",
                           generator=torch.Generator().manual_seed(1))

    return run


def _sweep():
    case = get_case("damped_oscillator")
    return train_sweep(_cfg(case, 20), case, [-0.5, 0.0, 0.5], seed=3,
                       chunk_size=None, device="cpu")


@pytest.fixture(scope="module")
def runs(beam):
    """Each call off, then on with its recording's export."""
    out = {}
    for what, call in (("train_model", beam), ("train_sweep", _sweep)):
        off = call()
        with spans.recording() as rec:
            on = call()
        out[what] = off, on, rec.export()
    return out


def _by_name(out):
    named = {}
    for s in out["spans"]:
        named.setdefault(s[3], []).append(s)
    return named


def _no_event(*args, **kwargs):
    raise AssertionError("a CUDA event was made")


def test_off_records_nothing_and_makes_no_event(beam, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    with spans.recording() as rec:
        pass
    assert spans.span("graph.replay", device=True).__enter__() is None
    assert spans.job("train_model").__enter__() is None
    spans.count("graph.replays")
    beam()
    out = rec.export()
    assert out["spans"] == [] and out["counters"] == {}
    assert out["device"] == {}


def test_train_model_records_its_job(runs):
    out = runs["train_model"][2]
    named = _by_name(out)
    (job,) = named["job"]
    jid = job[0]
    assert job[1] is None and job[2] == jid
    assert job[6] == {"entry": "train_model", "members": 1, "n_iter": 30}
    assert {s[2] for s in out["spans"]} == {jid}
    (setup,) = named["train.setup"]
    assert setup[1] == jid
    blocks = named["train.block"]
    assert [s[6] for s in blocks] == [{"b": b, "graphed": False}
                                      for b in range(3)]
    assert all(s[1] == jid for s in blocks)
    waits = named["train.flag_wait"]
    assert [w[1] for w in waits] == [b[0] for b in blocks[1:]]
    assert sorted(named) == ["job", "train.block", "train.flag_wait",
                             "train.setup"]
    for s in out["spans"]:
        assert job[4] <= s[4] <= s[5] <= job[5]
    assert out["counters"] == {} and out["device"] == {}


def test_sweep_records_chunks_under_its_job(runs):
    out = runs["train_sweep"][2]
    named = _by_name(out)
    (job,) = named["job"]
    assert job[6] == {"entry": "train_sweep", "members": 3, "n_iter": 20}
    (chunk,) = named["sweep.chunk"]
    assert chunk[1] == job[0]
    (starts,) = named["sweep.member_starts"]
    (setup,) = named["train.setup"]
    assert starts[1] == setup[1] == chunk[0]
    assert [(s[1], s[6]["b"]) for s in named["train.block"]] == [
        (chunk[0], 0), (chunk[0], 1)]
    assert {s[2] for s in out["spans"]} == {job[0]}


def test_a_call_inside_a_job_joins_it(beam):
    with spans.recording() as rec:
        with spans.job("study") as outer:
            beam()
    out = rec.export()
    named = _by_name(out)
    assert [s[6]["entry"] for s in named["job"]] == ["study"]
    assert {s[2] for s in out["spans"]} == {outer.row[0]}
    assert named["train.setup"][0][1] == outer.row[0]


@pytest.mark.parametrize("what", ["train_model", "train_sweep"])
def test_recording_changes_no_number(runs, what):
    off, on, _ = runs[what]
    if what == "train_model":
        (p_off, logs_off), (p_on, logs_on) = off, on
        p_off, p_on = p_off.state_dict(), p_on.state_dict()
    else:
        p_off, logs_off, p_on, logs_on = off.params, off.logs, on.params, \
            on.logs
    assert p_off.keys() == p_on.keys()
    for k in p_off:
        assert torch.equal(p_off[k], p_on[k]), k
    for a, b in zip(logs_off, logs_on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        else:
            assert a == b


def test_counters_threads_and_clock():
    seen = {}
    with spans.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with spans.recording():
                pass
        with spans.span("outer"):
            spans.count("n")
            spans.count("n", 4)

            def other():
                with spans.span("elsewhere") as sp:
                    seen["parent"] = sp.row[1]

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with spans.span("inner") as inner:
                inner.set(k=1)
    out = rec.export()
    named = _by_name(out)
    assert out["counters"] == {"n": 5}
    assert seen["parent"] is None
    assert named["inner"][0][1] == named["outer"][0][0]
    assert named["inner"][0][6] == {"k": 1}
    assert len(out["anchors"]) == 2
    t = named["outer"][0][4]
    offsets = [u - p for p, u in out["anchors"]]
    assert min(offsets) <= spans.unix_ns(out, t) - t <= max(offsets)
