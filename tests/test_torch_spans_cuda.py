"""The span recorder on the card: a graphed ``train_model`` records one
capture and a replay a block after the first, each replay with a CUDA
event pair that resolves; the capture's kernel and memcpy nodes are the
kernels and copies one ``cudaGraphLaunch`` starts in a profiler slice
(matched by correlation id; a memcpy node runs as a copy kernel, or on
the copy engine in a graph instantiated after the profiler first
attached to the process); and the spans, mapped onto the profiler's
clock by the recording's anchors, hold every traced ``cudaGraphLaunch``:
each launch lies inside exactly one ``graph.replay`` span, within 20 µs.
The params and logs are the same bit for bit with recording on and off.

The slice is PyTorch's Kineto profiler with the card's activities only,
started after the second block's launch and stopped after the fifth's
(from ``train_model``'s progress callback), so it holds whole replays and
no capture. Every test here needs an NVIDIA GPU (marker ``cuda``) and
skips without one. Run it on the card without the repository's conftest
(which imports jax), with ``-s`` to see the clock's measured error:

    python -m pytest tests/test_torch_spans_cuda.py --noconftest -q -s
"""

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils import spans
from dpivae_tpu_torch.utils.data import sample_response

pytestmark = pytest.mark.cuda

N_ITER, VAL_FREQ = 60, 10
SLICE_BLOCKS = (1, 4)  # the profiler starts after block 1, stops after 4
TOLERANCE_NS = 20_000


def _profile_start():
    from torch.autograd import ProfilerActivity
    from torch.autograd.profiler import (
        ProfilerConfig,
        ProfilerState,
        _enable_profiler,
        _ExperimentalConfig,
        _prepare_profiler,
    )

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    activities = {ProfilerActivity.CUDA}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities)


def _profile_stop():
    from torch.autograd.profiler import _disable_profiler

    torch.cuda.synchronize()
    launches, kernels = [], []
    for e in _disable_profiler().events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(("Memset", "Memory")):
                kernels.append(e.correlation_id())
        elif name == "cudaGraphLaunch":
            launches.append((e.start_ns(), e.correlation_id()))
    return launches, kernels


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=256, n_val=64, n_batch=32, n_mc_train=8, n_mc_val=8,
        n_iter=N_ITER, val_freq=VAL_FREQ, use_seed=True, use_pallas=True,
        patience=10**9)
    g = torch.Generator(device=device).manual_seed(0)
    data_train = sample_response(case, g, cfg.n_train,
                                 sample_dist=case.gt_dist(), device=device)
    data_val = sample_response(case, g, cfg.n_val,
                               sample_dist=case.gt_dist(), device=device)
    model = setup_model(cfg, case, data_train, device=device)
    params = init_params(cfg, model, device=device)
    sliced = {}

    def progress(it, *rows):
        block = it // VAL_FREQ
        if block == SLICE_BLOCKS[0]:
            _profile_start()
        elif block == SLICE_BLOCKS[1]:
            sliced["events"] = _profile_stop()

    def run(progress=False):
        return train_model(cfg, model, case, data_train, data_val,
                           params=params, device=device, progress=progress,
                           generator=torch.Generator(
                               device=device).manual_seed(1))

    off = run()
    with spans.recording() as rec:
        on = run(progress)
    return off, on, rec.export(), sliced["events"]


def _named(out, name):
    return [s for s in out["spans"] if s[3] == name]


def test_one_capture_and_a_replay_a_block(runs):
    _, _, out, _ = runs
    n_blocks = N_ITER // VAL_FREQ
    assert out["counters"]["graph.captures"] == 1
    assert out["counters"]["graph.replays"] == n_blocks - 1
    (capture,) = _named(out, "graph.capture")
    assert capture[6]["kernel_nodes"] == out["counters"]["graph.kernel_nodes"]
    assert capture[6]["kernel_nodes"] > 0
    replays = _named(out, "graph.replay")
    blocks = {s[0]: s for s in _named(out, "train.block")}
    assert [blocks[r[1]][6] for r in replays] == [
        {"b": b, "graphed": True} for b in range(1, n_blocks)]
    eager = [s for s in blocks.values() if s[6]["b"] == 0]
    paired = [eager[0]] + replays
    assert set(out["device"]) == {s[0] for s in paired}
    last_end = 0
    for s in paired:
        t0, t1 = out["device"][s[0]]
        assert last_end <= t0 <= t1
        last_end = t1


def test_kernel_nodes_are_a_launchs_kernels_and_copies(runs):
    _, _, out, (launches, kernels) = runs
    (capture,) = _named(out, "graph.capture")
    assert len(launches) == SLICE_BLOCKS[1] - SLICE_BLOCKS[0]
    for _, cid in launches:
        assert kernels.count(cid) == capture[6]["kernel_nodes"]
    print(f"\nkernel nodes {capture[6]['kernel_nodes']}, a step "
          f"{capture[6]['kernel_nodes'] / VAL_FREQ}")


def test_spans_hold_every_traced_launch_on_the_profilers_clock(runs):
    _, _, out, (launches, _) = runs
    replays = [(spans.unix_ns(out, s[4]), spans.unix_ns(out, s[5]))
               for s in _named(out, "graph.replay")]
    errors, margins = [], []
    for start, _ in launches:
        near = [(a, b) for a, b in replays
                if a - TOLERANCE_NS <= start <= b + TOLERANCE_NS]
        assert len(near) == 1, (start, near)
        a, b = near[0]
        errors.append(max(a - start, start - b, 0))
        margins.append((start - a, b - start))
    offsets = [u - p for p, u in out["anchors"]]
    print(f"\nclock: the profiler's = perf_counter_ns + "
          f"{spans.unix_ns(out, 0)} ns; the anchors' offsets differ by "
          f"{max(offsets) - min(offsets)} ns; launches outside their span "
          f"by at most {max(errors)} ns; (launch - span start, span end - "
          f"launch) in ns: {margins}")


def test_recording_changes_no_number(runs):
    (p_off, logs_off), (p_on, logs_on), _, _ = runs
    for (k, a), (_, b) in zip(p_off.state_dict().items(),
                              p_on.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(logs_off, logs_on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        else:
            assert a == b
