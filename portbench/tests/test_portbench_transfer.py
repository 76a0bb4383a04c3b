"""The transfer cell (``bridge_transfer24``: the bridge's P model through
``train_sweep_data``): its files found by name, a small run of its driver
on the CPU that is correct, and not correct with the timed path broken
underneath; its two readers on a synthetic record; its frozen count
against a hand count and against PyTorch's counter on the reference; its
domains against the port's; and its reference importing nothing of the
port."""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common, run
from portbench.drivers import transfer_jobs
from portbench.reference import dpivae_p as ref_p
from portbench.tests.test_portbench_imports import _loaded_after
from portbench.work import counts, counts_p

BENCH = common.load_benchmark()
CELL = "bridge_transfer24"
CFG = common.read_json("configs", "bridge_p_dpivae_a")
SMALL = dict(n_iter=20, members=4)
MS = 1_000_000


def test_the_cells_files_are_found_by_name():
    work, cfg, mix, limits = common.cell(BENCH, CELL)
    assert (work["config"], work["chips"]) == ("bridge_p_dpivae_a", 1)
    assert cfg["name"] == "bridge_p_dpivae_a" and cfg["reduced"] == []
    assert mix["kind"] == "transfer_jobs" and mix["members"] == 24
    assert set(limits) == {"loss0_gap", "sigma_gap", "change_gap"}
    assert common.driver(mix["kind"]) is transfer_jobs
    for name in ("member_setup_ms", "train_mfu_pct.pmodel"):
        assert callable(common.metric_reader(name))
    listed = {m["name"] for m in BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == {"job_fixed_s", "block_ms", "kernels_per_step",
                      "device_idle_pct.train", "member_setup_ms",
                      "train_mfu_pct.pmodel"}


def test_the_configuration_is_what_the_program_runs():
    tc, case = transfer_jobs.train_config(CFG, torch.device("cpu"))
    assert tc.model_type == "P" and case.idx_c_phys == (1,)
    wrong = dict(CFG, idx_c_phys=[])
    with pytest.raises(ValueError, match="idx_c_phys"):
        transfer_jobs.train_config(wrong, torch.device("cpu"))
    wider = dict(CFG, physics=dict(CFG["physics"], layers=[3, 64, 64, 64]))
    with pytest.raises(ValueError, match="physics.layers"):
        transfer_jobs.train_config(wider, torch.device("cpu"))


def _run(seed=2 ** 31 + 977):
    rec, _, checks, _ = run.execute(BENCH, CELL, seed, 0.5, False,
                                    torch.device("cpu"), time.perf_counter,
                                    SMALL)
    return run.verdict(rec, checks), checks, rec


def test_sound_run_is_correct():
    ok, checks, rec = _run()
    assert ok, checks
    assert rec["attempted"] >= 1 and rec["failed"] == 0


def _unchanged_state(monkeypatch):
    from dpivae_tpu_torch.train.optim import MemberAdam

    monkeypatch.setattr(MemberAdam, "step", lambda self, grads: None)


def _half_batch(monkeypatch):
    from dpivae_tpu_torch.models.vae import DPIVAE

    loss = DPIVAE.loss

    def half(self, params, x, *args, **kwargs):
        out = loss(self, params, x, *args, **kwargs)
        h = x.shape[0] // 2
        return tuple(torch.cat([o[:h], o[:h]]) for o in out)

    monkeypatch.setattr(DPIVAE, "loss", half)


def _skipped_group(monkeypatch):
    made = transfer_jobs.train_config

    def without_decoder_y(cfg, device, **overrides):
        tc, case = made(cfg, device, **overrides)
        return tc.replace(lr_dy=0.0), case

    monkeypatch.setattr(transfer_jobs, "train_config", without_decoder_y)


def _altered_loss(monkeypatch):
    from dpivae_tpu_torch.train import train

    body = train.MemberTrainer.step_body

    def altered(self, *args, **kwargs):
        return body(self, *args, **kwargs) * (1.0 + 1e-3)

    monkeypatch.setattr(train.MemberTrainer, "step_body", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _skipped_group, _altered_loss])
def test_a_planted_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    ok, checks, _ = _run()
    assert not ok, checks


def _record():
    """A traced run's record: two graph launches of 10 steps in the
    slice, and the port's spans of three data-sweep jobs."""
    runtime, device = [], [("spin_kernel", 0, 10, (1,))]
    for i, start in enumerate((100, 200)):
        runtime.append(("cudaGraphLaunch", start * MS, start * MS + 5000,
                        (10 + i,)))
        device.append(("k", (start + 1) * MS, (start + 51) * MS, (10 + i,)))
    spans = []
    for job, t in ((1, 0), (10, 100), (20, 200)):
        spans.append((job, None, job, "job", t * MS, (t + 50) * MS,
                      {"entry": "train_sweep_data"}))
        spans.append((job + 1, job, job, "sweep.member_data", t * MS,
                      (t + 2 + job // 10) * MS, {"bytes": 8, "members": 4}))
        spans.append((job + 2, job, job, "sweep.chunk", (t + 3) * MS,
                      (t + 40) * MS, {}))
        spans.append((job + 3, job + 2, job, "sweep.member_starts",
                      (t + 3) * MS, (t + 13) * MS, {}))
    return {"slice": {"device": device, "runtime": runtime,
                      "window_ns": (0, 500 * MS)},
            "val_freq": 10, "members": 24, "work": CFG,
            "program": {"spans": spans, "counters": {}}}


def test_the_new_readers():
    rec = _record()
    # jobs after the first: 3 + 10 and 4 + 10 ms
    assert common.metric_reader("member_setup_ms")(rec) == pytest.approx(13.5)
    assert common.metric_reader("train_mfu_pct.pmodel")(rec) == pytest.approx(
        100 * 2 * 10 * 24 * counts_p.train_step_flops(CFG)
        / (0.5 * counts.TF32_FLOPS))


def test_the_readers_with_nothing_to_read_return_nothing():
    rec = _record()
    rec["program"]["spans"] = [s for s in rec["program"]["spans"]
                               if s[3] != "sweep.member_data"]
    assert common.metric_reader("member_setup_ms")(rec) is None
    rec.pop("program")
    assert common.metric_reader("member_setup_ms")(rec) is None
    rec["slice"]["runtime"] = []
    assert common.metric_reader("train_mfu_pct.pmodel")(rec) is None


def test_counts_p_by_hand():
    # the three encoders: 64 -> 64, then loc, log-sigma and tril heads
    enc = sum(2 * (64 * 64 + 64 * (2 * n + n * n)) for n in (2, 4, 4))
    prior = 2 * 2 * (2 * 64 + 64 * 8)
    decoders = 2 * (8 * 128 + 128 * 64) + 2 * 2 * (4 * 64 + 64 * 4)
    physics = 2 * (3 * 64 + 64 * 32 + 32 * 64 + 64 * 64)
    assert enc == 31_744
    assert counts_p.loss_forward_flops(CFG, 1, 1) == (
        enc + prior + decoders + physics)
    assert counts_p.loss_forward_flops(CFG, 5, 3) == (
        5 * (enc + prior) + 15 * (decoders + physics))
    assert counts_p.train_step_flops(CFG) == pytest.approx(
        3 * counts_p.loss_forward_flops(CFG, 64, 16)
        + counts_p.loss_forward_flops(CFG, 512, 64) / 10)


def test_counts_p_against_the_counter_on_the_reference():
    points, mc = 6, 3
    g = torch.Generator().manual_seed(3)
    data = ref_p.domain_response(CFG, ref_p.load_arrays(CFG, "cpu"), g,
                                 points, 2)
    reference = ref_p.Reference(CFG, data, torch.device("cpu"),
                                ref_p.load_arrays(CFG, "cpu", "part_"))
    weights = ref_p.seeded_init(CFG, g)
    eps = torch.randn(mc, points, 10, generator=g)
    with FlopCounterMode(display=False) as fc:
        reference.loss_comps(weights, *data, eps, -1.0)
    assert fc.get_total_flops() == counts_p.loss_forward_flops(CFG, points,
                                                               mc)


def test_domains_are_the_studys():
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.utils.priors import make_square_dist

    # the study's extrapolation direction trains on the one-quadrant boxes
    boxes, _ = make_square_dist(get_case("bridge"))[::-1]
    for domain, box in enumerate(boxes):
        low, high = ref_p.domain_box(CFG, domain)
        np.testing.assert_allclose(low.numpy(), box.low)
        np.testing.assert_allclose(high.numpy(), box.high)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    tops = _loaded_after("portbench.reference.dpivae_p")
    assert not tops & {"dpivae_tpu_torch", "dpivae_tpu", "jax", "jaxlib",
                       "flax"}
    tops = _loaded_after("portbench.drivers.transfer_jobs")
    assert not tops & {"dpivae_tpu", "jax", "jaxlib", "flax"}
