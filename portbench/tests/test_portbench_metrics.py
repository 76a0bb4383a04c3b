"""Each per-layer metric's reader on a small recorded synthetic slice."""

import pytest

from portbench import common, trace
from portbench.work import counts

BENCH = common.load_benchmark()
CFG = common.read_json("configs", "beam_s_dpivae")
MS = 1_000_000


def _train_rec():
    runtime = [("cudaLaunchKernel", 120 * MS, 120 * MS + 1000, (5,))]
    device = [("spin_kernel", 0, 10, (1,)),
              ("k_eager", 130 * MS, 230 * MS, (5,))]
    for i, start in enumerate((500, 600, 700)):
        cid = 10 + i
        runtime.append(("cudaGraphLaunch", start * MS, start * MS + 5000,
                        (cid,)))
        device.append(("k_step", (start + 1) * MS, (start + 11) * MS, (cid,)))
        device.append(("void fused_mlp_fwd_kernel<4>", (start + 11) * MS,
                       (start + 13) * MS, (0, cid)))
    ev = {"device": device, "runtime": runtime,
          "window_ns": (0, 1000 * MS)}
    return {"slice": ev, "val_freq": 10, "members": 1, "work": CFG,
            "spans": [("job", 2.0, 9.0, 500, True)], "job_fixed_s": 0.4}


def test_training_readers():
    rec = _train_rec()
    read = lambda n: common.metric_reader(n)(rec)
    assert read("job_fixed_s") == pytest.approx(0.4)
    assert read("block_ms") == pytest.approx(100.0)
    assert read("kernels_per_step") == pytest.approx(6 / 30)
    assert read("device_idle_pct.train") == pytest.approx(100 - 13.6)
    least = counts.train_block_fused_least_s(CFG)
    assert read("fused_mlp_roofline_pct.train") == pytest.approx(
        100 * 3 * least / 0.006)
    assert read("train_mfu_pct") == pytest.approx(
        100 * 30 * counts.train_step_flops(CFG) / counts.TF32_FLOPS)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = _train_rec()
    rec["slice"]["runtime"] = [r for r in rec["slice"]["runtime"]
                               if r[0] != "cudaGraphLaunch"]
    rec.pop("job_fixed_s")
    for name in ("job_fixed_s", "block_ms", "kernels_per_step",
                 "fused_mlp_roofline_pct.train"):
        assert common.metric_reader(name)(rec) is None


def test_breakdown_names_what_the_host_did_in_the_gaps():
    ev = _train_rec()["slice"]
    ev["runtime"].append(("cudaStreamSynchronize", 240 * MS, 490 * MS, (9,)))
    bd = trace.breakdown(ev)
    idle = dict(bd["idle_gaps"])
    # the gap from 230 to 501 ms has its middle inside the synchronize
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.271)
    assert sum(idle.values()) == pytest.approx(1.0 - 0.136)
    assert dict(bd["device_ops"])["k_step"] == pytest.approx(0.030)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
