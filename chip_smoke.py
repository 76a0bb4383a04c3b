#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dpivae_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off so every f32 product is full f32.
2. Build: compiles ``dpivae_tpu_torch/csrc/fused_mlp.cu`` with nvcc for
   sm_90a into ``build/dpivae_tpu_torch/`` and prints the build time and
   ptxas's register/shared-memory report.
3. Kernel vs plain: the fused-MLP kernel against its plain PyTorch version
   on the same CUDA inputs at the serving shape (512 requests x 512 MC
   samples = 262,144 rows x (4 -> 128 -> 32)), the training shape, a
   ragged row count and hidden 256, with both timed by CUDA events.
4. Main path: simple_beam / "dpivae" preset with use_pallas=True at full
   width, random weights from a seed; a Predictor answers requests of
   n_test = 512 points with n_mc_test = 512 MC samples. The kernel's launch
   count over that run must equal the number of requests, the outputs must
   be finite and of the right shapes, and they must agree with a
   use_pallas=False model of the same weights under the same seeds.
   Each model's per-request time is taken in alternating turns.
5. Profile: torch.profiler's device view of one request (busy share, top
   kernels) and the fused-MLP kernel's device time per launch.
6. Prints a ``{"kernels": [...]}`` line and, last, the device line.

Tolerance for both comparisons: rtol 1e-5 / atol 1e-5, the forward
tolerance of tests/test_pallas_mlp.py. Both sides are full f32 and differ
only in summation order; through the predictor only x_sample and xh_d see
the kernel, averaged over 512 samples.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
RTOL = ATOL = 1e-5
N_REQUESTS = 3
N_TIMED_REQUESTS = 20
# Least-time bound: H100 SXM published peaks
# (f32 outside the tensor cores; HBM3), at the full 700 W power limit.
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# (rows, d_in, d_hidden, d_out); "serving" is the main path's shape.
SHAPES = {
    "serving": (262_144, 4, 128, 32),
    "training": (1_024, 4, 128, 32),
    "ragged": (1_000, 4, 128, 32),
    "hidden256": (65_536, 4, 256, 32),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events. A sleep kernel queued first lets
    the host enqueue all calls before the first starts, so host overhead
    between launches is not counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _bound_ms(rows, d_in, d_hidden, d_out):
    flops = 2 * rows * (d_in * d_hidden + d_hidden * d_out)
    n_bytes = 4 * (rows * d_in + rows * d_out
                   + d_hidden * d_in + d_hidden + d_out * d_hidden + d_out)
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _kernel_vs_plain(fused_mlp, fused_mlp_reference, failures):
    results = {}
    for i, (name, (rows, d_in, d_hidden, d_out)) in enumerate(SHAPES.items()):
        g = torch.Generator(device="cuda").manual_seed(SEED + i)
        f = lambda *s: torch.randn(s, generator=g, device="cuda")
        args = (f(rows, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
                f(d_out, d_hidden) * 0.3, f(d_out) * 0.1)
        with torch.inference_mode():
            got = fused_mlp(*args)
            want = fused_mlp_reference(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp_min(1e-30)).max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            ms = _device_ms(lambda: fused_mlp(*args))
            plain_ms = _device_ms(lambda: fused_mlp_reference(*args))
        bound_ms, bound_by = _bound_ms(rows, d_in, d_hidden, d_out)
        print(f"kernel {name} {rows}x({d_in}->{d_hidden}->{d_out}): "
              f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(rtol {RTOL} atol {ATOL}) {'ok' if ok else 'MISMATCH'}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            failures.append(f"fused_mlp disagrees with plain at {name}")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return results


def _main_path(fused_mlp, failures):
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.serving import SAMPLE_SLOTS, Predictor
    from dpivae_tpu_torch.train import init_params, setup_model
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_pallas=True, use_seed=True, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    if not model.use_pallas:
        failures.append("use_pallas=True did not select the kernel")
    params = init_params(cfg, model, device="cuda")
    outputs = tuple(SAMPLE_SLOTS)
    predictor = Predictor(model, params, cfg, outputs=outputs, device="cuda")
    plain = Predictor(dataclasses.replace(model, use_pallas=False), params,
                      cfg, outputs=outputs, device="cuda")
    requests = [
        sample_response(case, gen, cfg.n_test, sample_dist=case.gt_dist(),
                        device="cuda")[:2]
        for _ in range(N_REQUESTS)
    ]
    torch.cuda.synchronize()

    fused_mlp.launches = 0
    answers = [predictor(x, c, seed=i) for i, (x, c) in enumerate(requests)]
    launches = fused_mlp.launches

    print(f"main path: {N_REQUESTS} requests of {cfg.n_test} points x "
          f"{cfg.n_mc_test} MC samples; fused_mlp launches {launches}")
    if launches != N_REQUESTS:
        failures.append(f"expected {N_REQUESTS} kernel launches on the main "
                        f"path, counted {launches}")
    widths = dict(x_sample=case.nd_x, xh_p=case.nd_x, xh_d=case.nd_x,
                  c_sample=case.nd_c, y=case.nd_y, zx=case.nz_x,
                  zc=cfg.nz_c, zy=cfg.nz_y)
    lb = torch.tensor([p.lb for p in case.prior_x])
    ub = torch.tensor([p.ub for p in case.prior_x])
    worst = 0.0
    for i, ((x, c), answer) in enumerate(zip(requests, answers)):
        want = plain(x, c, seed=i)
        for name in outputs:
            got = torch.from_numpy(answer[name])
            if tuple(got.shape) != (cfg.n_test, widths[name]):
                failures.append(f"{name} has shape {tuple(got.shape)}")
            if not torch.isfinite(got).all():
                failures.append(f"{name} is not finite")
            ref = torch.from_numpy(want[name])
            worst = max(worst, float((got - ref).abs().max()))
            if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
                failures.append(f"{name} of request {i} disagrees with the "
                                f"use_pallas=False model")
        zx = torch.from_numpy(answer["zx"])
        if not ((zx >= lb) & (zx <= ub)).all():
            failures.append("zx left the prior bounds")
    print(f"main path vs use_pallas=False model: max_abs_err {worst:.3e} "
          f"(rtol {RTOL} atol {ATOL})")

    # Per-request time, kernel and plain models in alternating turns.
    x, c = requests[0]
    times = {predictor: [], plain: []}
    for p in times:
        for _ in range(3):
            p(x, c, seed=0)
    for i in range(N_TIMED_REQUESTS):
        for p in ((predictor, plain) if i % 2 == 0 else (plain, predictor)):
            t0 = time.perf_counter()
            p(x, c, seed=i)  # returns numpy: ends in a device sync
            times[p].append(1e3 * (time.perf_counter() - t0))
    for name, p in (("kernel", predictor), ("plain", plain)):
        q1, q2, q3 = statistics.quantiles(times[p], n=4)
        print(f"per request, {name} model: median {q2:.3f} ms, quartiles "
              f"{q1:.3f}-{q3:.3f} ms over {N_TIMED_REQUESTS} requests")
    return (launches, statistics.median(times[predictor]),
            statistics.median(times[plain]), predictor, requests[0])


def _profile(predictor, request, fused_mlp):
    """Device-side view from torch.profiler: one warm request's kernels and
    device busy share, and the fused-MLP kernel's own device time per launch
    at the serving and training shapes. Runs after the counted main path."""
    from torch.profiler import ProfilerActivity, profile

    def device_events(prof):
        return [e for e in prof.key_averages()
                if e.self_device_time_total > 0]

    x, c = request
    predictor(x, c, seed=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(x, c, seed=0)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile of one request: wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in events)} device ops")
    for e in events[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:<3d} "
              f"{e.key[:90]}")

    for name in ("serving", "training"):
        rows, d_in, d_hidden, d_out = SHAPES[name]
        g = torch.Generator(device="cuda").manual_seed(SEED)
        f = lambda *s: torch.randn(s, generator=g, device="cuda")
        args = (f(rows, d_in), f(d_hidden, d_in), f(d_hidden),
                f(d_out, d_hidden), f(d_out))
        with torch.inference_mode():
            fused_mlp(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fused_mlp(*args)
                torch.cuda.synchronize()
        mine = [e for e in device_events(prof) if "fused_mlp" in e.key]
        if mine:
            per = mine[0].self_device_time_total / mine[0].count / 1e3
            print(f"profile: fused_mlp_fwd_kernel at {name} "
                  f"{rows}x({d_in}->{d_hidden}->{d_out}): {per:.4f} ms "
                  f"device time per launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dpivae_tpu_torch.ops.fused_mlp import (
        build_library,
        fused_mlp,
        fused_mlp_reference,
    )

    card = _card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    t0 = time.perf_counter()
    lib_path, log = build_library()
    print(f"built {os.path.relpath(lib_path)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    results = _kernel_vs_plain(fused_mlp, fused_mlp_reference, failures)
    launches, req_ms, req_plain_ms, predictor, request = _main_path(
        fused_mlp, failures)
    print(f"per request ({card}): kernel model {req_ms:.3f} ms, "
          f"plain model {req_plain_ms:.3f} ms "
          f"(warm median of {N_TIMED_REQUESTS})")
    _profile(predictor, request, fused_mlp)

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    serving = results["serving"]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "dpivae_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "dpivae_tpu/ops/pallas_mlp.py:38",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
