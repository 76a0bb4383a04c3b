#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dpivae_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off so every f32 product of the plain versions is full f32.
2. Build: compiles ``dpivae_tpu_torch/csrc/fused_mlp.cu`` (both kernels)
   with nvcc for sm_90a into ``build/dpivae_tpu_torch/`` and prints the
   build time and ptxas's register/shared-memory report.
3. Kernels vs plain, on the same CUDA inputs, both timed by CUDA events:
   the fused-MLP forward kernel at the serving shape (512 requests x 512
   MC samples = 262,144 rows x (4 -> 128 -> 32)), the validation shape
   (512 points x 64 MC), the training shape (64 x 16 MC), the same three
   at the damped_oscillator and bridge widths (8 -> 128 -> 64), the
   figures' decodes (2,000 rows at both widths), a ragged row count, the row counts on either side of the forward's switch from
   its split to its staged path, and hidden 256, 512 and 1,024, each with
   two least-time bounds (layer 2 in f32 on the CUDA cores, and on the
   TF32 tensor cores in three passes) and, at the serving, validation and
   training shapes, beside the two-call cuBLASLt pair
   torch._addmm_activation then torch.addmm as a yardstick (the port
   never calls it); the hidden-recompute kernel at both training shapes
   (4 -> 128 and 8 -> 128), a ragged row count and 65,536 x (4 -> 256),
   also against the one library call that computes it
   (torch._addmm_activation: GEMM with a bias + ReLU epilogue) and beside
   a fill_ of the same output (the card's practical write rate); and
   FusedMLPFunction's backward against autograd through the plain forward
   at the training shape. Then both forward paths, each forced, at 1,024,
   8,192, 16,384 and 32,768 rows: the measurement behind the launcher's
   switch between them. Then the forward and plain f32 each against
   float64 at H = 256 to 1,024 (printed, not checked). Last, the CNN
   encoder (damped_oscillator's S-model widths) on the card with cuDNN's
   TF32 flag at its default, on, against the same module in float64 on
   the CPU (the module in f32 on the CPU printed beside it, not checked).
4. Serving path: simple_beam / "dpivae" preset with use_pallas=True at
   full width, random weights from a seed; a Predictor answers requests
   of n_test = 512 points with n_mc_test = 512 MC samples. The forward
   kernel's launch count over that run must equal the number of requests,
   the outputs must be finite and of the right shapes, and they must agree
   with a use_pallas=False model of the same weights under the same seeds.
   Each model's per-request time is taken in alternating turns. The
   Predictors replay CUDA graphs (``cuda_graph="auto"``,
   ``utils/graph_cache.py``) from their first request on; the memory the
   graph cache holds is printed after the requests.
5. Serving profile: torch.profiler's device view of one request (busy
   share, top kernels), the forward kernel's device time per launch at the
   serving, training and 65,536 x (4 -> 256 -> 32) shapes, and the hidden
   kernel's at 65,536 x (4 -> 256).
6. Training path: ``train_model`` on simple_beam / "dpivae" with
   use_pallas=True at full width (n_train 1,024, batch 64, 16 MC samples,
   validation of 512 points x 64 MC every 10 iterations, as bench.py
   times it), n_iter cut from 20,000 to 500 (2,000 before the single
   run of phase 8 joined, 1,000 before phase 15, for the time limit;
   phase 8 runs the preset's full length).
   The forward kernel must
   launch n_iter + n_iter / val_freq times and the hidden kernel n_iter
   times; every active log row must be finite, the last ELBO_val below
   the first, and the first 10 train rows must agree with a
   use_pallas=False run from the same seeds and weights. Steps/s of both
   models from one warm run each, in turns (cut from two each, for the
   time limit), and torch.profiler's view of one warm train step.
7. The damped_oscillator / bridge slice, at 8 -> 128 -> 64: bridge /
   "DPIVAE-A" (the P model, a frozen-MLP partial physics, the physical
   covariate delta_xs joined to z_x) through phase 4's serving checks and
   a profile of one request, then phase 6's training checks with n_iter
   cut to 500 (1,000 before phase 8); damped_oscillator / "dpivae" (S
   model) through phase 4's
   serving checks. Every path's launches are counted from zero just
   before it and read just after.
8. The single-run program, ``dpivae_tpu_torch.scripts.single_run``'s
   ``main`` in process, on simple_beam / "dpivae" at full width with the
   preset's use_pallas="auto", at the preset's own length (20,000
   iterations) and early stop (patience 200), output in a temporary
   directory under build/: "auto" must pick the kernel on this card; the
   forward must launch blocks run x (val_freq + 1) times and the hidden
   kernel blocks run x val_freq times, the blocks run following the stop
   iteration (the evaluation and the baselines launch neither); every
   logged row up to the stop must be finite; the trained model is held
   against BASELINE.md's anchor of this row (the JAX package's run at the
   reference's scale: stop 12,971, train / val ELBO -1.006 / -1.121, test
   y-R² 0.986 against LIN 0.879, GPR 0.988, MLP 0.916): the VAE's test
   y-R² at least the anchor's less R2_MARGIN, the ELBO_val at the
   returned params (the stop's validation) within ELBO_TOL of the
   anchor's, the VAE's R² above LIN's; the stop iteration, both ELBOs and
   LIN / GPR / MLP are printed beside the anchor's (not checked: the data
   come from another random stream than JAX's). Every metric CSV must be
   there with its header and finite values; ``load_model`` of the saved
   checkpoint must give a Predictor whose eight outputs equal the
   in-memory model's under the same seed exactly; LIN, GPR, MLP and the
   VAE must score finite R², MSE and MAE, LIN's R² within 1e-3 of
   float64 least squares on the same features (the MLP is scikit-learn's fit, ``eval.fit_mlp_sklearn``: its
   epochs printed); ``evaluate_model`` at 512 points x 512 MC must launch
   no forward. The run passes --export_serving: the artifact it wrote,
   loaded on the card, must give the checkpoint's plain Predictor's y at
   seed 0 for the test set. Then ``disentanglement_metric`` with linear
   probes, with the batched ``mlp_jax`` probes (epochs cut from 300 to
   30) and with scikit-learn's ``mlp`` probes (their epochs printed). Each
   stage's wall time and the phase's are printed.
9. The decode's options at bench.py's workload, 200 steps each, each
   after a warm-up run of 20 steps, so that its steps/s compare with phase
   6's warm run: remat_decode with use_pallas=True (the forward launches
   2 n_iter + n_iter / val_freq times, the hidden kernel n_iter; the first
   10 train rows agree with a remat_decode=False run from the same seeds
   and weights), and compute_dtype="bfloat16" with "auto" (no launch;
   finite log rows).
10. Sweeps (damped_oscillator / "dpivae", 8 -> 128 -> 64, 66 members):
   the member-batched kernels (one launch over a member axis) against the
   batched plain version (torch.baddbmm, ReLU, torch.baddbmm) on the same
   inputs, the forward at 66 x 1,024 and 66 x 32,768 rows, the hidden
   kernel at 66 x 1,024, and FusedMLPFunction's backward under
   torch.func.vmap(grad) at 66 x 1,024, each with its bound at the summed
   rows; then ``train_sweep`` at bench.py's sweep workload (66 members,
   λ = linspace(-1, 1, 66), patience 10^9), n_iter cut from 2,000 to 300,
   once with use_pallas "auto" (the plain path in sweeps) and once with
   use_pallas=True, each after a 20-step warm-up: every chunk's forward
   launches n_iter + n_iter / val_freq times and its hidden kernel n_iter
   times, every active row is finite, members differ, the two runs' first
   10 rows agree, and a member's first 10 rows equal a single train_model
   run from that member's data, init and generator; member-steps/s of
   both, and a profile of one batched step. Last, the disentanglement
   study (``dpivae_tpu_torch.scripts.disentanglement_metric``) in
   process, 11 λ x 6 runs, n_iter cut from 20,000 to 300, linear probes,
   output under build/: its score rows and files, then a second call on
   the same output that resumes every chunk (no training step, no kernel
   launch) and writes the same scores, and a third with --regressor mlp
   (scikit-learn's MLPRegressor(128, 128) fit on every probe at once) that
   resumes too: finite scores, the probes' epochs printed.
11. The serving artifact (``serving.save_predictor``/``load_predictor``,
   ``torch.export``): phase 4's use_pallas=True model, all eight outputs,
   exported (on the CPU, through the plain decode, with one warning) and
   loaded on the card, answers requests of 1, 7 and 512 points x 512 MC
   as the live plain Predictor and the live kernel Predictor do under the
   same seed; the kernel Predictor launches the forward once per request,
   the artifact never; warm per-request times of the three, in rotating
   turns. Then bridge / "DPIVAE-A" with cond=True, exported before any
   eager call of a fresh case (its surrogate's constants cache stays
   empty), against its live Predictor.
12. The transfer study (``dpivae_tpu_torch.scripts.regression_comparison``)
   in process as a user runs it: bridge, extrapolation, 6 runs x 4
   domains = 24 members per preset, --baselines jax, n_iter cut from
   20,000 to 300, output under build/: "auto" launches neither kernel;
   raw_metrics.csv has 120 finite rows of the five models, table.tex both
   tables, timings.json every phase; mean R² per model beside
   BASELINE.md's. A second call with --skip_baselines resumes every chunk
   (no training step, no launch) and gives the same DPIVAE rows. A third
   with the default --baselines sklearn (member by member; its GPR fitted
   as scikit-learn fits it, float64 L-BFGS-B) resumes too: 120 finite
   rows, the same DPIVAE rows, LIN rows equal to the batched call's
   (atol 1e-4); GPR and MLP mean R² of both choices beside BASELINE.md's,
   the sklearn MLP's epochs per member (it is fitted by MLPRegressor's
   rules, every member at once) and the baselines stage's seconds.
   ``export_member_predictor`` of one member against ``member_model``'s
   Predictor. Then ``train_sweep_data`` on the same 24 "DPIVAE-A"
   datasets (the P model), 100 steps after a 20-step warm-up, with "auto"
   and with use_pallas=True: each chunk's forward launches n_iter +
   n_iter / val_freq times and its hidden kernel n_iter times, the first
   10 rows of the two agree, a member's equal its single train_model run;
   member-steps/s of both and a profile of one batched P-model step.
13. The figures' data (``viz.visualization``) on the card, at the
   config's n_plot 2,000 and n_interp 5, nothing cut: every figure that
   ``single_run --plots`` draws from device data, for phase 8's trained
   simple_beam / "dpivae" model ("auto", so the kernel), then the two
   prediction figures of bridge / "DPIVAE-A" (P model, cond, random
   weights, use_pallas=True). Each figure's data are computed with the
   model, counted and timed, then with a use_pallas=False copy under the
   same seeds and held against it; the prediction figures launch the
   forward once per traversal point (4 factors x 5 points x 2 figures = 40
   for simple_beam), the posterior and prior figures never. Nothing is
   drawn: the card's host has no matplotlib.
14. The device mesh (``dpivae_tpu_torch.parallel``): ``make_mesh(1,
   ("dp",))`` must come up as a one-rank NCCL group on cuda:0 (a gloo
   group fails the phase). ``train_model(mesh=...)`` on simple_beam /
   "dpivae" at bench.py's workload with the preset's "auto" (the kernels),
   500 steps after a 20-step warm-up of each run: the block graph with
   its NCCL all-reduces captured (one capture, one replay and one host
   read a block after the first; the forward launches n_iter + n_iter /
   val_freq times and the hidden kernel n_iter times), against the same
   mesh's eager loop (``cuda_graph=False``; params and logs equal, max
   difference 0) and against the graphed run without the mesh (max
   difference printed; rtol/atol 1e-5, a one-rank sum being the
   identity), steps/s of all three in turns, and torch.profiler's view of
   one replayed data-parallel block beside an eager one (the NCCL kernels
   and memcpys, the busy share). Then
   ``train_sweep`` over 66 damped_oscillator members with use_pallas=True,
   200 steps, over a one-rank "sweep" mesh against the unsharded sweep
   (equal; launches counted; member-steps/s of both), and the study
   (``disentanglement_metric``, 11 λ x 6 runs, linear probes, 200 steps)
   with ``--n_devices 1`` against the study without the flag: the same
   disentanglement_score.csv. The process group is destroyed at the end.
15. The decode's options in sweeps, a CNN-encoder model and the example
   programs. Phase 10's 66-member damped_oscillator sweep with
   use_pallas=True and remat_decode=True, 200 steps after a 20-step
   warm-up, against the same sweep without remat (in turns): remat's
   forward launches 2 n_iter + n_iter / val_freq times (the forward, then
   the recompute in the backward) and its hidden kernel n_iter times, the
   first 10 rows agree, the params' max difference printed, member-steps/s
   of both, and torch.cuda.max_memory_allocated over one warm batched step
   of each (reset between), whole and with mc_chunk 4. The same sweep
   with compute_dtype="bfloat16" and "auto": no launch, finite rows. Then
   remat's memory at the JAX package's w1024_b1024_mc64 cell (simple_beam,
   its physics a width-1,024 two-hidden-layer tanh surrogate, hidden_width
   1,024, batch 1,024, 64 MC): one single-run train step's peak above its
   start with and without remat, unchunked and in 8 MC chunks (remat must
   peak lower in chunks), launches counted, and the allocations live at
   the unchunked peaks, from the allocator's recorded history. damped_oscillator / "dpivae" with
   the Conv1d encoder trunk (encoder_x="CNN"), 200 steps with
   use_pallas=True (n_iter + n_iter / val_freq and n_iter launches)
   against use_pallas=False: finite rows, the first 10 agree. Then the
   examples in process: ``examples.custom_case`` (500 steps: "auto" picks
   the kernels, 550 / 500 launches, the ELBO falls, the test R² printed),
   ``examples.hyper_search`` (200 steps, 2 seeds: finite, the ranking
   printed) and ``examples.serve_http`` serving phase 11's artifact on
   127.0.0.1 from a thread: 20 POSTs of phase 4's 512-point request, each
   equal to ``ServedPredictor`` called directly with the same seed, the
   median wall of both, and 4 concurrent clients equal to serial calls.
16. The block graph of the training loop (``train/train.py``,
   ``train/graph.py``; every training above already ran through it,
   "auto" on CUDA) against the eager loop (``cuda_graph=False``) from the
   same seeds and weights, each pair's rows, validations and params
   compared (max_abs_err expected 0), and each graphed run's loop counted:
   one capture, then one replay and one host read of the all-stopped
   flag a block, one block behind, so a run ends one block after its
   stop; launches blocks run x (val_freq + 1) forward and blocks run x
   val_freq hidden (the steps masked past a stop or past n_iter launch
   too). simple_beam / "dpivae" at bench.py's workload with
   use_pallas=True, 500 steps, with a sigmoid λ and a cyclical β_x
   schedule (both change inside the window), steps/s of both loops as
   the median of 3 warm runs each in turns, and one replayed block's
   wall, device busy share and kernels under torch.profiler beside one
   eager block's, with the block graph's pool; an early stop at block 1
   (a β_x scaled by 10 that is 0 at block 0's validation and 10 at block
   1's, learning rates 1e-5: 3 blocks run), one in a later block
   (patience 1, a one-sample validation and 10x learning rates, 200
   steps) and a partial last block (n_iter 55: 6 blocks, 60 steps
   launched); phase 10's 66-member damped_oscillator sweep, 300 steps,
   "auto" (plain) and use_pallas=True, member-steps/s of both loops in
   turns, a replayed 66-member block profiled, and the use_pallas=True
   sweep with per-member early stops (patience 1, min_delta 0, a
   one-sample validation and 10x learning rates: members stop at their
   own blocks, frozen inside the graph); phase 12's 24-member bridge /
   "DPIVAE-A" grid (P model, use_pallas=True, 100 steps); and the 66
   members with remat_decode (200 steps, the forward twice a step).
17. The graphed inference path (``utils/graph_cache.py``; every inference
   above already ran through it, "auto" on CUDA) against the eager calls
   (``cuda_graph=False``) from the same seeds and weights, max_abs_err
   expected 0 and the forward's launches counted in both: phase 4's
   simple_beam Predictor with the kernel and plain, and phase 7's bridge
   and damped_oscillator Predictors, 3 requests of 512 x 512 MC and all
   eight outputs each (one launch a request with the kernel); requests of
   512, 7, 512 and 7 points in turns (two graphs on one memory pool);
   phase 11's artifact at 1, 7, 512 and 7 points; per-request medians and
   quartiles of the graphed and eager kernel Predictor and artifact
   (alternating turns), torch.profiler's view of one replayed and one
   eager request and one replayed artifact request, and cProfile's host
   view of 20 replayed requests; the bytes and graphs
   the cache holds; ``evaluate_model``'s y and ``sample_latents`` at 512 x
   512 MC and the caller's generator after them (its next draw equal);
   one prediction figure's data and ``marginal_prior_data`` of phase 8's
   model at 2,000 x 5, equal, and the wall of each, graphed and eager.
   Then the sweeps' sampling graphs (``sweep/sweep.py`` through
   ``utils/graph_cache.py``'s member-chunk entries), from an empty member
   cache: ``sweep_sample`` (nine slots, 128 points x 16 MC),
   ``sweep_predict_y`` (n_test x n_mc_test) and
   ``sweep_disentanglement_latents`` (the study's 2,048 + 2,048 probe
   points) of phase 10's 66-member "auto" sweep (3 chunks of 22) and of
   phase 12's 24-member use_pallas=True grid (5 chunks of 5, one pad),
   each in turns graphed (its capture included), eager, graphed, eager,
   graphed: every output equal to eager (max_abs_err 0), every member's
   generator at the same next draw, one capture and one replay a chunk
   after it, the forward's launches one a chunk both ways in the grid's
   ``sweep_sample``, the walls; the member entries' bytes before and
   after an eviction by their bound; and the walls of the study's latents
   stage and the transfer study's predict stages of phases 10 and 12.
18. Prints a ``{"kernels": [...]}`` line (launches summed over every path),
   the script's wall time and, last, the device line.

Tolerances: values rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol
1e-5, as in tests/test_pallas_mlp.py. The plain versions are full f32;
the kernels compute layer 1 in f32 and the forward's layer 2 in the
3xTF32 split, which keeps about 21 bits of each product, so the two
differ by little more than summation order; the errors printed are the
kernel's own on the card. Through the predictor only x_sample and xh_d see
the kernel, averaged over 512 samples. The training rows get rtol / atol
1e-4: ten Adam steps carry the summation-order differences of every
step's gradients forward.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
# Launch checks of training: a run launches blocks run x (val_freq + 1)
# forward and blocks run x val_freq hidden kernels (one forward and one
# hidden a step, masked steps included, one forward a validation; the
# forward twice a step under remat_decode). Every n_iter below is a
# multiple of val_freq, and the runs that are not checked for a stop
# (``_check_loop``) do not stop, so their blocks run are n_iter /
# val_freq: n_iter + n_iter / val_freq forward and n_iter hidden.
RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_TOL = 1e-4
N_ITER = 500   # cut from the preset's 20,000 for the time limit
N_ITER_BRIDGE = 500   # cut further for the time limit
# Phase 8's single run at the preset's 20,000 iterations, held against
# BASELINE.md's anchor "simple_beam, S "dpivae"" (the JAX package's run at
# the reference's scale): the VAE's test y-R² at least the anchor's less
# R2_MARGIN, the ELBO_val at the returned params within ELBO_TOL of it.
SINGLE_RUN_ANCHOR = dict(stop=12_971, elbo_train=-1.006, elbo_val=-1.121,
                         r2={"VAE": 0.986, "LIN": 0.879, "GPR": 0.988,
                             "MLP": 0.916})
R2_MARGIN = 0.03
ELBO_TOL = 0.15
N_ITER_DECODE_OPTIONS = 200
N_ITER_WARM = 20   # a warm-up run before each timed options or sweep run
N_ITER_SWEEP = 300   # bench.py's sweep workload's 2,000, cut for the limit
N_ITER_STUDY = 300   # the study's 20,000, cut for the limit
SWEEP_MEMBERS = 66
N_ITER_TRANSFER = 300   # the transfer study's 20,000, cut for the limit
N_ITER_TRANSFER_KERNEL = 100   # the use_pallas=True transfer grid's
TRANSFER_RUNS = 6   # the study's own: 6 runs x 4 domains = 24 members
N_ITER_MESH = 500   # the mesh's data-parallel run, cut for the limit
N_ITER_MESH_SWEEP = 200   # the mesh's sweep and study, cut for the limit
N_ITER_SWEEP_OPTIONS = 200   # phase 15's sweeps with remat and bf16
MC_CHUNK_MEMORY = 4   # phase 15's chunked step: 4 chunks of 16 samples
# Phase 15's remat cell, the JAX package's w1024_b1024_mc64
# (bench.py:123-178), and its chunked step: 8 chunks of 8 samples.
REMAT_WIDTH = 1024
REMAT_MC = 64
MC_CHUNKS_REMAT = 8
N_ITER_CNN = 200   # phase 15's CNN-encoder model, cut for the limit
N_ITER_CUSTOM = 500   # the custom case example's 2,000, cut for the limit
N_ITER_HYPER = 200   # the hyper search example's 2,000, cut for the limit
N_HTTP_REQUESTS = 20
# Phase 16, the graphed loop against the eager loop: simple_beam's run
# (phase 6's length), the early-stop run, and the warm runs of each loop
# timed in turns. Annealed schedules (the config's sigmoid and cyclical
# defaults: λ's midpoint at step 75 of 500, β_x's cycles of 100 steps)
# so that a schedule row baked into a graph would show.
N_ITER_GRAPH = 500
N_ITER_GRAPH_STOP = 200
N_ITER_GRAPH_STOP_1 = 100
N_ITER_GRAPH_PARTIAL = 55   # a partial last block: 5 steps past n_iter
GRAPH_TIMED_RUNS = 3
GRAPH_ANNEALING = dict(lambda_annealing="sigmoid",
                       beta_x_annealing="cyclical")
# Early stops that latch under the graph: patience 1 with no dead zone, a
# one-sample validation (noisy) and 10x learning rates.
GRAPH_EARLY_STOP = dict(patience=1, min_delta=0.0, n_mc_val=1,
                        **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc",
                                                     "dy")})
# A stop that latches at block 1, the first it can latch at: a cyclical
# β_x of 20-step cycles whose ramp is half of each, scaled by 10, so 0 at
# block 0's validation and 10 at block 1's, lifts the validation loss by
# ten times the KL of z_x, and learning rates of 1e-5 keep training from
# undoing it.
GRAPH_STOP_BLOCK_1 = dict(
    patience=1, min_delta=0.0, beta_x0=10.0, beta_x_annealing="cyclical",
    beta_x_n_cycles=5, beta_x_R=0.5,
    **{f"lr_{k}": 1e-5 for k in ("e", "p", "dx", "dc", "dy", "sigma")})
# BASELINE.md's JAX transfer study (extrapolation, 20,000 steps, reference
# scale), mean ± std of the test R² over its 24 folds: a quality
# reference printed beside this run's, not a threshold.
TRANSFER_R2_REFERENCE = {"DPIVAE-A": "0.631 ± 0.232",
                         "DPIVAE-B": "0.789 ± 0.101", "GPR": "0.826 ± 0.102",
                         "LIN": "0.632 ± 0.246", "MLP": "0.443 ± 0.288"}
PROBE_EPOCHS = 30   # the MLP probes', cut from 300
LSTSQ_TOL = 1e-3
N_ROWS_COMPARED = 10
N_REQUESTS = 3
N_TIMED_REQUESTS = 20
# Phase 17 (c), the sweeps' sampling graphs: sweep_sample of all nine
# slots at 128 points x 16 MC; sweep_predict_y at the config's n_test x
# n_mc_test, as the transfer study's predict stage asks it; the latents at
# the study's 2,048 + 2,048 probe points (its --n_train_regressor and
# --n_test_regressor), one sample, as its latents stage asks them; the
# grid in chunks of at most 5, so that one member is padded.
SWEEP_SAMPLE_POINTS, SWEEP_SAMPLE_MC = 128, 16
STUDY_PROBE_POINTS = 2_048
GRID_SAMPLING_CHUNK = 5
# Least-time bound: H100 SXM published peaks (f32 outside the tensor
# cores; dense TF32 on the tensor cores; HBM3), at the full 700 W power
# limit.
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12
# (rows, d_in, d_hidden, d_out); "serving" and "training" are the shapes of
# the serving and training paths.
SHAPES = {
    "serving": (262_144, 4, 128, 32),
    "validation": (32_768, 4, 128, 32),
    "training": (1_024, 4, 128, 32),
    # the same three of the damped_oscillator and bridge paths
    "serving8": (262_144, 8, 128, 64),
    "validation8": (32_768, 8, 128, 64),
    "training8": (1_024, 8, 128, 64),
    "ragged": (1_000, 4, 128, 32),
    # the figures' decodes: the config's n_plot of 2,000 responses per
    # traversal point, at simple_beam's and at bridge's widths
    "figures": (2_000, 4, 128, 32),
    "figures8": (2_000, 8, 128, 64),
    # the last row count of the forward's split path, and the first of
    # its staged path
    "split_edge": (8_192, 4, 128, 32),
    "staged_edge": (16_384, 4, 128, 32),
    "hidden256": (65_536, 4, 256, 32),
    # hidden widths of the scaling study: H = 512 on the staged path;
    # H = 1,024, whose staged weights exceed one block's shared memory, on
    # the split path at every row count
    "hidden512": (32_768, 4, 512, 32),
    "hidden1024": (32_768, 4, 1_024, 32),
}
# Row counts at 4 -> 128 -> 32 where the forward runs on each of its two
# paths, forced, against plain: two on each side of the launcher's switch.
PATH_ROWS = (1_024, 8_192, 16_384, 32_768)
# (rows, d_in, d_hidden, d_out) where the forward and plain are each held
# against float64 with the CUDA tests' fixed weight scale (W1 0.3 at every
# H), printed and not checked.
F64_SHAPES = ((65_536, 4, 256, 32), (32_768, 4, 512, 32),
              (32_768, 4, 1_024, 32), (4_096, 8, 1_024, 64))
# Forward shapes timed beside the cuBLASLt pair.
PAIR_SHAPES = ("serving", "validation", "training", "serving8",
               "validation8", "training8", "figures", "figures8")
# (rows, d_in, d_hidden) of the hidden-recompute kernel; "training" and
# "training8" are the training paths' shapes.
HIDDEN_SHAPES = {
    "training": (1_024, 4, 128),
    "training8": (1_024, 8, 128),
    "ragged": (1_000, 4, 128),
    "hidden256": (65_536, 4, 256),
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
    back-to-back calls, by CUDA events. A sleep kernel queued first, longer
    than the host takes to enqueue the calls, lets the host enqueue all of
    them before the first starts, so host overhead between launches is not
    counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # Cycles at 2 GHz or less, twice the host's enqueue time
    sleep_cycles = max(5_000_000, int(4e9 * host_s))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _bound_ms(rows, d_in, d_hidden, d_out):
    """The forward's two least times, each (ms, what bounds it): both
    layers in f32 on the CUDA cores; and layer 2 on the TF32 tensor cores
    in the three passes of the 3xTF32 split, layer 1 on the CUDA cores.
    The second is the kernel's bound."""
    layer1 = 2 * rows * d_in * d_hidden
    layer2 = 2 * rows * d_hidden * d_out
    n_bytes = 4 * (rows * d_in + rows * d_out
                   + d_hidden * d_in + d_hidden + d_out * d_hidden + d_out)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_f32 = (layer1 + layer2) / F32_FLOPS_PER_S
    t_tensor = max(3 * layer2 / TF32_FLOPS_PER_S, layer1 / F32_FLOPS_PER_S)
    return tuple((1e3 * max(t, t_bytes),
                  "operations" if t >= t_bytes else "bytes")
                 for t in (t_f32, t_tensor))


def _hidden_bound_ms(rows, d_in, d_hidden):
    flops = 2 * rows * d_hidden * (d_in + 1)
    n_bytes = 4 * (rows * d_in + d_hidden * d_in + d_hidden + rows * d_hidden)
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _backward_bound_ms(rows, d_in, d_hidden, d_out):
    """The backward's least time: its products (dh, dW1, dW0, dx and the
    hidden recompute) and the bytes of x, g, the weights and the five
    gradients."""
    flops = 2 * rows * (d_out * d_hidden * 2 + d_in * d_hidden * 3)
    n_bytes = 8 * (rows * d_in + d_hidden * d_in + d_hidden
                   + d_out * d_hidden + d_out) + 4 * rows * d_out
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _randn(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *s: torch.randn(s, generator=g, device="cuda")


def _hidden_library(x, w0, b0):
    """The one PyTorch call that computes relu(x @ w0.T + b0): a GEMM with
    a bias + ReLU epilogue (cuBLASLt on CUDA). Timed for comparison only;
    the port never calls it."""
    return torch._addmm_activation(b0, x, w0.t())


def _forward_library(x, w0, b0, w1, b1):
    """The forward in two PyTorch calls, cuBLASLt GEMMs with a bias + ReLU
    epilogue and then a bias: a yardstick only, since no one call computes
    both layers; the port never calls it."""
    return torch.addmm(b1, torch._addmm_activation(b0, x, w0.t()), w1.t())


def _hidden_vs_plain(ops, failures):
    results = {}
    for i, (name, (rows, d_in, d_hidden)) in enumerate(HIDDEN_SHAPES.items()):
        f = _randn(SEED + 10 + i)
        args = (f(rows, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1)
        with torch.inference_mode():
            got = ops.fused_mlp_hidden(*args)
            want = ops.fused_mlp_hidden_reference(*args)
            lib = _hidden_library(*args)
            torch.cuda.synchronize()
            max_abs = float((got - want).abs().max())
            lib_abs = float((lib - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            lib_ok = bool(torch.allclose(lib, want, rtol=RTOL, atol=ATOL))
            ms = _device_ms(lambda: ops.fused_mlp_hidden(*args))
            plain_ms = _device_ms(lambda: ops.fused_mlp_hidden_reference(*args))
            library_ms = _device_ms(lambda: _hidden_library(*args))
            # The card's practical write rate: a fill of the same bytes.
            fill_ms = _device_ms(lambda: got.fill_(1.0))
        bound_ms, bound_by = _hidden_bound_ms(rows, d_in, d_hidden)
        print(f"hidden kernel {name} {rows}x({d_in}->{d_hidden}): "
              f"max_abs_err {max_abs:.3e} (rtol {RTOL} atol {ATOL}) "
              f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (_addmm_activation, max_abs_err "
              f"{lib_abs:.3e}) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), fill_ of the same output {fill_ms:.4f} ms")
        if not ok:
            failures.append(f"fused_mlp_hidden disagrees with plain at {name}")
        if not lib_ok:
            failures.append(f"torch._addmm_activation disagrees with plain at "
                            f"{name}: its time is not of the same function")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
    return results


def _backward_vs_plain(ops, failures):
    """FusedMLPFunction's backward (hidden kernel + plain products) against
    autograd through fused_mlp_reference, at the training shape."""
    rows, d_in, d_hidden, d_out = SHAPES["training"]
    f = _randn(SEED + 20)
    args = [t.requires_grad_() for t in
            (f(rows, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
             f(d_out, d_hidden) * 0.3, f(d_out) * 0.1)]
    g = f(rows, d_out)
    y_kernel = ops.fused_mlp(*args)
    y_plain = ops.fused_mlp_reference(*args)
    if type(y_kernel.grad_fn).__name__ != "FusedMLPFunctionBackward":
        failures.append("fused_mlp under autograd did not use FusedMLPFunction")
    got = torch.autograd.grad(y_kernel, args, g, retain_graph=True)
    want = torch.autograd.grad(y_plain, args, g, retain_graph=True)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("dx", "dw0", "db0", "dw1", "db1"), got, want):
        max_abs = max(max_abs, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL):
            failures.append(f"FusedMLPFunction's {name} disagrees with "
                            f"autograd through the plain version")
    ms = _device_ms(lambda: torch.autograd.grad(y_kernel, args, g,
                                                retain_graph=True))
    plain_ms = _device_ms(lambda: torch.autograd.grad(y_plain, args, g,
                                                      retain_graph=True))
    bound_ms, bound_by = _backward_bound_ms(rows, d_in, d_hidden, d_out)
    print(f"backward training {rows}x({d_in}->{d_hidden}->{d_out}): five "
          f"gradients max_abs_err {max_abs:.3e} (rtol {GRAD_RTOL} atol "
          f"{GRAD_ATOL}); FusedMLPFunction {ms:.4f} ms, plain autograd "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)


def _kernel_vs_plain(fused_mlp, fused_mlp_reference, failures):
    results = {}
    for i, (name, (rows, d_in, d_hidden, d_out)) in enumerate(SHAPES.items()):
        g = torch.Generator(device="cuda").manual_seed(SEED + i)
        f = lambda *s: torch.randn(s, generator=g, device="cuda")
        args = (f(rows, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
                f(d_out, d_hidden) * _w1_scale(d_hidden), f(d_out) * 0.1)
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
            if name in PAIR_SHAPES:
                lib = _forward_library(*args)
                lib_abs = float((lib - want).abs().max())
                if not torch.allclose(lib, want, rtol=RTOL, atol=ATOL):
                    failures.append(f"the cuBLASLt pair disagrees with plain "
                                    f"at {name}: its time is not of the same "
                                    f"function")
                pair_ms = _device_ms(lambda: _forward_library(*args))
        (f32_ms, f32_by), (bound_ms, bound_by) = _bound_ms(
            rows, d_in, d_hidden, d_out)
        print(f"kernel {name} {rows}x({d_in}->{d_hidden}->{d_out}): "
              f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(rtol {RTOL} atol {ATOL}) {'ok' if ok else 'MISMATCH'}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; layer 2 3xTF32 on the "
              f"tensor cores, {100 * bound_ms / ms:.1f} % of it reached), "
              f"f32 CUDA-core bound {f32_ms:.4f} ms ({f32_by})")
        if name in PAIR_SHAPES:
            print(f"  yardstick {name}: cuBLASLt pair (_addmm_activation + "
                  f"addmm, max_abs_err {lib_abs:.3e}) {pair_ms:.4f} ms "
                  f"against the kernel's {ms:.4f} ms")
        if not ok:
            failures.append(f"fused_mlp disagrees with plain at {name}")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=(pair_ms if name in PAIR_SHAPES
                                         else None))
    return results


def _w1_scale(d_hidden):
    """W1's scale, as in tests/test_torch_port_cuda.py: 0.3, and above
    H = 256 smaller, so that the outputs keep H = 256's spread."""
    return 0.3 * min(1.0, (256 / d_hidden) ** 0.5)


def _against_f64(ops):
    """The forward and plain f32 each against float64 at W1 scale 0.3, so
    outputs spread as √H: printed, not checked. Where the kernel misses
    rtol/atol 1e-5 against plain, this says whether plain f32 itself
    misses it against float64 there."""
    for rows, d_in, d_hidden, d_out in F64_SHAPES:
        f = _randn(SEED + 40)
        args = (f(rows, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
                f(d_out, d_hidden) * 0.3, f(d_out) * 0.1)
        with torch.inference_mode():
            got = ops.fused_mlp(*args)
            plain = ops.fused_mlp_reference(*args)
            exact = ops.fused_mlp_reference(*(a.double() for a in args))
            torch.cuda.synchronize()

            def miss(a, b):
                b = b.to(a.dtype)
                return (float((a - b).abs().max()), int((~torch.isclose(
                    a, b, rtol=RTOL, atol=ATOL)).sum()))

            (kp, kp_n), (kx, kx_n), (px, px_n) = (
                miss(got, plain), miss(got.double(), exact),
                miss(plain.double(), exact))
        print(f"float64 check {rows}x({d_in}->{d_hidden}->{d_out}), W1 0.3, "
              f"output std {float(exact.std()):.2f}: max_abs_err (elements "
              f"outside rtol/atol {RTOL}) kernel vs plain {kp:.3e} ({kp_n}), "
              f"kernel vs f64 {kx:.3e} ({kx_n}), plain vs f64 {px:.3e} "
              f"({px_n})")


def _paths_vs_plain(ops, failures):
    """The forward's split and staged paths, each forced, against plain
    and against each other, at row counts on both sides of the switch."""
    for rows in PATH_ROWS:
        f = _randn(SEED + 30)
        args = (f(rows, 4), f(128, 4) * 0.3, f(128) * 0.1, f(32, 128) * 0.3,
                f(32) * 0.1)
        with torch.inference_mode():
            want = ops.fused_mlp_reference(*args)
            line = []
            for staged in (False, True):
                got = ops.fused_mlp_on_path(*args, staged=staged)
                torch.cuda.synchronize()
                name = "staged" if staged else "split"
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    failures.append(f"the {name} path disagrees with plain "
                                    f"at {rows} rows")
                ms = _device_ms(lambda: ops.fused_mlp_on_path(
                    *args, staged=staged))
                line.append(f"{name} {ms:.4f} ms (max_abs_err "
                            f"{float((got - want).abs().max()):.3e})")
        print(f"forward paths {rows}x(4->128->32): {', '.join(line)}")


def _serving(ops, failures, case_name, preset):
    """A serving path: the case's preset with use_pallas=True at full
    width, random weights from the seed; a Predictor answers N_REQUESTS
    requests of n_test points x n_mc_test MC samples, counted, checked
    against a use_pallas=False model of the same weights, and timed in
    alternating turns. Returns (forward launches, kernel and plain model
    per-request medians in ms, the predictor, one request, the model's
    (config, case, model, params))."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.serving import SAMPLE_SLOTS, Predictor
    from dpivae_tpu_torch.train import init_params, setup_model
    from dpivae_tpu_torch.utils.data import sample_response

    what = f"{case_name} / {preset!r}"
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        use_pallas=True, use_seed=True, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    if not model.use_pallas:
        failures.append(f"{what}: use_pallas=True did not select the kernel")
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

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    answers = [predictor(x, c, seed=i) for i, (x, c) in enumerate(requests)]
    launches = ops.fused_mlp.launches
    hidden_launches = ops.fused_mlp_hidden.launches

    print(f"serving path {what} ({model.model_type} model, idx_c_phys "
          f"{model.idx_c_phys}): {N_REQUESTS} requests of {cfg.n_test} "
          f"points x {cfg.n_mc_test} MC samples; launches fused_mlp_fwd "
          f"{launches}, fused_mlp_hidden {hidden_launches}")
    if (launches, hidden_launches) != (N_REQUESTS, 0):
        failures.append(f"{what}: expected {N_REQUESTS} forward and no "
                        f"hidden kernel launches on the serving path, "
                        f"counted {launches} and {hidden_launches}")
    from dpivae_tpu_torch.utils import graph_cache

    print(f"graph cache after {what}'s requests: {graph_cache.entries()} "
          f"graphs, {graph_cache.held_bytes() / 1e6:.1f} MB held")
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
                failures.append(f"{what}: {name} has shape "
                                f"{tuple(got.shape)}")
            if not torch.isfinite(got).all():
                failures.append(f"{what}: {name} is not finite")
            ref = torch.from_numpy(want[name])
            worst = max(worst, float((got - ref).abs().max()))
            if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
                failures.append(f"{what}: {name} of request {i} disagrees "
                                f"with the use_pallas=False model")
        zx = torch.from_numpy(answer["zx"])
        if not ((zx >= lb) & (zx <= ub)).all():
            failures.append(f"{what}: zx left the prior bounds")
    print(f"serving path {what} vs use_pallas=False model: max_abs_err "
          f"{worst:.3e} (rtol {RTOL} atol {ATOL})")

    # Per-request time, kernel and plain models in alternating turns.
    times = _per_request_times({"kernel": predictor, "plain": plain},
                               *requests[0])
    for name, t in times.items():
        q1, q2, q3 = statistics.quantiles(t, n=4)
        print(f"per request {what}, {name} model: median {q2:.3f} ms, "
              f"quartiles {q1:.3f}-{q3:.3f} ms over {N_TIMED_REQUESTS} "
              f"requests")
    return (launches, statistics.median(times["kernel"]),
            statistics.median(times["plain"]), predictor, requests[0],
            (cfg, case, model, params))


def _device_events(prof):
    """Kernel-level device events (kernels, copies, fills), largest first.
    An aten op's own device time is the sum of its kernels', and the
    profiler also puts user-annotation ranges (Optimizer.step) on the
    device timeline, so only kernel-level events are summed."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)


def _print_profile(what, events, wall_ms, unprofiled_ms):
    """Device busy time of a profiled window, its share of the same work's
    unprofiled wall time, and the top device kernels."""
    if not events:
        print(f"profile of {what}: the profiler saw no device time "
              f"(not measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile of {what}: device busy {busy_ms:.3f} ms in "
          f"{sum(e.count for e in events)} device kernels; "
          f"{100 * busy_ms / unprofiled_ms:.1f} % of the unprofiled wall "
          f"{unprofiled_ms:.3f} ms (wall under the profiler {wall_ms:.3f} ms)")
    for e in events[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def _per_launch(events, kernel, what):
    mine = [e for e in events if kernel in e.key]
    if mine:
        per = mine[0].self_device_time_total / mine[0].count / 1e3
        print(f"profile: {kernel} at {what}: {per:.4f} ms device time per "
              f"launch (x{mine[0].count})")


def _profile_request(what, predictor, request, request_ms):
    """torch.profiler's device view of one warm request: its kernels and
    the device's busy share. Runs after the counted serving path."""
    from torch.profiler import ProfilerActivity, profile

    x, c = request
    predictor(x, c, seed=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(x, c, seed=0)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    _print_profile(what, _device_events(prof), wall_ms, request_ms)


def _profile_kernels(fused_mlp, fused_mlp_hidden):
    """The fused-MLP kernel's own device time per launch by torch.profiler
    at the serving, training and 65,536 x (4 -> 256 -> 32) shapes, and the
    hidden kernel's at 65,536 x (4 -> 256)."""
    from torch.profiler import ProfilerActivity, profile

    for name in ("serving", "training", "hidden256"):
        rows, d_in, d_hidden, d_out = SHAPES[name]
        f = _randn(SEED)
        args = (f(rows, d_in), f(d_hidden, d_in), f(d_hidden),
                f(d_out, d_hidden), f(d_out))
        calls = [("fused_mlp_fwd_kernel", fused_mlp, args,
                  f"{name} {rows}x({d_in}->{d_hidden}->{d_out})")]
        if name == "hidden256":
            calls.append(("fused_mlp_hidden_kernel", fused_mlp_hidden,
                          args[:3], f"{name} {rows}x({d_in}->{d_hidden})"))
        for kernel, fn, fn_args, what in calls:
            with torch.inference_mode():
                fn(*fn_args)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fn(*fn_args)
                    torch.cuda.synchronize()
            _per_launch(_device_events(prof), kernel, what)


def _training(ops, failures, case_name, preset, n_iter):
    """A training path, ``n_iter`` steps of the case's preset at bench.py's
    workload: counted, checked against a use_pallas=False run of the same
    seeds and weights, and timed in turns, one warm run of each model.
    Returns ((forward, hidden) launches, steps/s by model, the run's
    setup)."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.train import (
        TRAIN_COLUMNS,
        init_params,
        setup_model,
        train_model,
    )
    from dpivae_tpu_torch.utils.data import sample_response

    what = f"{case_name} / {preset!r}"
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        use_pallas=True, use_seed=True, seed=SEED, patience=10**9,
        n_iter=n_iter)
    workload = (cfg.n_train, cfg.n_batch, cfg.n_mc_train, cfg.n_val,
                cfg.n_mc_val, cfg.val_freq)
    if workload != (1_024, 64, 16, 512, 64, 10):
        failures.append(f"{what}: training workload {workload} is not "
                        f"bench.py's")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    params = init_params(cfg, model, device="cuda")
    configs = {"kernel": cfg, "plain": cfg.replace(use_pallas=False)}

    def run(name):
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logs = train_model(configs[name], model, case, data_train,
                              data_val, params=params, generator=g,
                              device="cuda")
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    logs, cold_s = run("kernel")
    launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    want = (n_iter + n_iter // cfg.val_freq, n_iter)
    print(f"training path {what} ({model.model_type} model): {n_iter} steps "
          f"({cfg.n_batch} x {cfg.n_mc_train} MC, validation of {cfg.n_val} "
          f"x {cfg.n_mc_val} MC every {cfg.val_freq}) in {cold_s:.2f} s "
          f"(first run); launches fused_mlp_fwd {launches[0]}, "
          f"fused_mlp_hidden {launches[1]} (expected {want[0]}, {want[1]})")
    if launches != want:
        failures.append(f"{what}: training launches {launches}, expected "
                        f"{want}")

    train = logs.train[logs.train_active]
    val = logs.val[logs.val_active]
    if logs.stop_iter != n_iter:
        failures.append(f"{what}: training stopped at {logs.stop_iter}")
    if not (torch.isfinite(train).all() and torch.isfinite(val).all()):
        failures.append(f"{what}: a training log row is not finite")
    _, elbo_val = logs.scalars("ELBO_val")
    _, elbo = logs.scalars("ELBO")
    print(f"training path {what}: ELBO_val {elbo_val[0]:.4f} -> "
          f"{elbo_val[-1]:.4f}, ELBO {elbo[0]:.4f} -> {elbo[-1]:.4f}, "
          f"sigma_x "
          f"{float(logs.train[-1, TRAIN_COLUMNS.index('sigma_x')]):.4f}")
    if not elbo_val[-1] < elbo_val[0]:
        failures.append(f"{what}: ELBO_val did not decrease")

    plain_logs, _ = run("plain")
    got = logs.train[:N_ROWS_COMPARED]
    ref = plain_logs.train[:N_ROWS_COMPARED]
    worst = float((got - ref).abs().max())
    print(f"training path {what} vs use_pallas=False run: first "
          f"{N_ROWS_COMPARED} rows max_abs_err {worst:.3e} (rtol "
          f"{TRAIN_TOL} atol {TRAIN_TOL})")
    if not torch.allclose(got, ref, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append(f"{what}: the first train rows disagree with the "
                        f"use_pallas=False run")

    times = {name: run(name)[1] for name in ("kernel", "plain")}
    steps_s = {name: n_iter / t for name, t in times.items()}
    for name, t in times.items():
        print(f"training steps/s {what}, {name} model: {steps_s[name]:.1f} "
              f"(warm run of {n_iter} steps: {t:.3f} s)")
    return launches, steps_s, (cfg, case, model, params, data_train, data_val)


def _cnn_encoder_on_card(failures):
    """The Conv1d encoder at damped_oscillator's S-model widths (9 latents
    over nd_x 64), on the card with cuDNN's TF32 flag at its default (on),
    against the same module in float64 on the CPU. The f32 module on the
    CPU is printed beside it, not checked: on the card's host its first
    forward in a process has been seen to miss float64 by more than the
    tolerance while the card matched float64, a fault of the host's f32
    path and not of the encoder under test. Beside them, how far a cuDNN
    convolution of each conv layer's input under that flag lands from the
    encoder's own (printed, not checked)."""
    import copy

    import torch.nn.functional as F

    from dpivae_tpu_torch.models.encoders import CNNEncoder

    cpu = CNNEncoder(9, 64, torch.Generator().manual_seed(SEED),
                     torch.device("cpu"))
    card = copy.deepcopy(cpu).to("cuda")
    exact = copy.deepcopy(cpu).double()
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(SEED))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = [t.cpu() for t in card(x.cuda())]
            want = exact(x.double())
            host = cpu(x)
            h, cudnn_err = x.cuda()[:, :, None], []
            for conv in card.trunk.conv:
                mine = conv(h)
                cudnn = F.conv1d(h.permute(0, 2, 1), conv.weight, conv.bias,
                                 padding=1).permute(0, 2, 1)
                cudnn_err.append(float((cudnn - mine).abs().max()))
                h = torch.relu(mine)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    worst = max(float((g.double() - w).abs().max())
                for g, w in zip(got, want))
    host_err = max(float((g.double() - w).abs().max())
                   for g, w in zip(host, want))
    ok = all(torch.allclose(g.double(), w, rtol=RTOL, atol=ATOL)
             for g, w in zip(got, want))
    print(f"CNN encoder 512 x 64 -> 9 latents, cuDNN allow_tf32 on: (loc, "
          f"tril) on the card vs float64 on the CPU max_abs_err {worst:.3e} "
          f"(rtol {RTOL} atol {ATOL}) {'ok' if ok else 'MISMATCH'}; f32 on "
          f"the CPU vs float64 {host_err:.3e}, card vs f32 on the CPU "
          f"{max(float((g - w).abs().max()) for g, w in zip(got, host)):.3e} "
          f"(printed, not checked); conv layers 1 and 2 on the card, cuDNN "
          f"F.conv1d vs the encoder's own max_abs_err {cudnn_err[0]:.3e}, "
          f"{cudnn_err[1]:.3e}")
    if not ok:
        failures.append("the CNN encoder on the card disagrees with float64 "
                        "on the CPU")


def _profile_train_step(setup):
    """torch.profiler's view of one warm train step of the kernel model."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from dpivae_tpu_torch.train.train import Trainer

    cfg, case, _, params, data_train, data_val = setup
    run = Trainer(cfg, case, copy.deepcopy(params), data_train, data_val,
                  cfg.lambda_g0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for i in range(5):
        run.step(i, generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5, 25):
        run.step(i, generator=g)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(25, generator=g)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    _print_profile("one train step", events, wall_ms, step_ms)
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0
                   and not e.is_user_annotation),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"profile of one train step, host side: "
          f"{sum(e.count for e in host if e.key.startswith('aten::'))} aten "
          f"op calls (nested calls included); self CPU time under the "
          f"profiler, largest first:")
    for e in host[:6]:
        print(f"  {e.self_cpu_time_total / 1e3:8.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    for kernel in ("fused_mlp_fwd_kernel", "fused_mlp_hidden_kernel"):
        _per_launch(events, kernel, "training 1024 rows")


def _check_csvs(path, failures):
    """Every metric CSV of a run: present, its header, finite values."""
    import numpy as np

    from dpivae_tpu_torch.train import TRAIN_COLUMNS, VAL_COLUMNS

    headers = {"train": ["iter", *TRAIN_COLUMNS],
               "val": ["iter", *VAL_COLUMNS]}
    headers.update({n: ["iter", "value"]
                    for n in (*TRAIN_COLUMNS, *VAL_COLUMNS)})
    rows = 0
    for name, header in headers.items():
        file = os.path.join(path, f"{name}.csv")
        if not os.path.exists(file):
            failures.append(f"single run: {name}.csv is missing")
            continue
        with open(file) as f:
            first = f.readline().strip().split(",")
        values = np.loadtxt(file, delimiter=",", skiprows=1, ndmin=2)
        rows += len(values)
        if first != header:
            failures.append(f"single run: {name}.csv has header {first}")
        if not np.isfinite(values).all() or values.shape[1] != len(header):
            failures.append(f"single run: {name}.csv has non-finite values "
                            f"or {values.shape[1]} columns")
    print(f"single run: {len(headers)} metric CSVs with their headers, "
          f"{rows} rows, all finite")


def _lstsq_r2(data_train, data_test):
    """LIN's R² in float64: least squares with an intercept on the same
    standardized [x ‖ c] features (numpy.linalg.lstsq)."""
    import numpy as np

    x, c, y = (a.double().cpu().numpy() for a in data_train[:3])
    xt, ct, yt = (a.double().cpu().numpy() for a in data_test[:3])

    def features(a, b):
        f = np.concatenate(((a - x.mean(0)) / x.std(0),
                            (b - c.mean(0)) / c.std(0)), -1)
        return np.concatenate((f, np.ones((len(f), 1))), -1)

    coef = np.linalg.lstsq(features(x, c), y, rcond=None)[0]
    pred = features(xt, ct) @ coef
    return 1 - ((yt - pred) ** 2).sum(0) / ((yt - yt.mean(0)) ** 2).sum(0)


def _against_anchor(run, failures, card):
    """Phase 8's trained run against SINGLE_RUN_ANCHOR: every logged row
    up to the stop finite, the VAE's test y-R² at least the anchor's less
    R2_MARGIN and above LIN's, the ELBO_val at the returned params (the
    stop's validation) within ELBO_TOL of the anchor's; the rest printed
    beside the anchor's."""
    import numpy as np

    logs, a = run.logs, SINGLE_RUN_ANCHOR
    train = logs.train[logs.train_active]
    val = logs.val[logs.val_active]
    finite = bool(torch.isfinite(train).all() and torch.isfinite(val).all())
    elbo_train = float(logs.scalars("ELBO")[1][-1])
    elbo_val = float(logs.scalars("ELBO_val")[1][-1])
    r2 = {("VAE" if k == run.config.name else k): float(
        np.asarray(m["R2"]).reshape(-1)[0]) for k, m in run.metrics.items()}
    checks = {
        f"{len(train)} train and {len(val)} validation rows finite": finite,
        f"VAE test y-R² {r2['VAE']:.4f} >= {a['r2']['VAE']} - {R2_MARGIN}":
            r2["VAE"] >= a["r2"]["VAE"] - R2_MARGIN,
        f"ELBO_val {elbo_val:.4f} within {ELBO_TOL} of {a['elbo_val']}":
            abs(elbo_val - a["elbo_val"]) <= ELBO_TOL,
        f"VAE R² above LIN's {r2['LIN']:.4f}": r2["VAE"] > r2["LIN"],
    }
    print(f"single run against BASELINE.md's anchor ({card}): " + "; ".join(
        f"{what} {'ok' if ok else 'MISSED'}" for what, ok in checks.items()))
    print(f"single run beside the anchor (printed, not checked): stop "
          f"{logs.stop_iter} (anchor {a['stop']}), train / val ELBO "
          f"{elbo_train:.4f} / {elbo_val:.4f} (anchor {a['elbo_train']} / "
          f"{a['elbo_val']}), test y-R² " + ", ".join(
              f"{k} {r2[k]:.4f} (anchor {a['r2'][k]})"
              for k in ("VAE", "LIN", "GPR", "MLP")))
    failures.extend(f"single run against the anchor: {what}"
                    for what, ok in checks.items() if not ok)


def _single_run(ops, failures, card):
    """The single-run program in process (phase 8). Returns the (forward,
    hidden) launches of the run."""
    import tempfile

    import numpy as np

    from dpivae_tpu_torch.eval import baselines, disentanglement_metric
    from dpivae_tpu_torch.eval import evaluate_model
    from dpivae_tpu_torch.scripts import single_run
    from dpivae_tpu_torch.serving import SAMPLE_SLOTS, Predictor, load_predictor
    from dpivae_tpu_torch.train.checkpoint import load_model

    phase_t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as out:
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        with _EpochRecorder(baselines) as mlp_epochs:
            run = single_run.main([
                "--case", "simple_beam", "--preset", "dpivae", "--name",
                "chip_smoke", "--output", out, "--device", "cuda",
                "--export_serving"])
        wall = time.perf_counter() - t0
        launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
        cfg = run.config
        blocks = _blocks_run(run.logs, cfg)
        want = _block_launches(blocks, cfg)
        print(f"single run simple_beam / 'dpivae' ({card}): use_pallas "
              f"{cfg.use_pallas!r} resolved to {run.model.use_pallas}; "
              f"n_iter {cfg.n_iter}, patience {cfg.patience}, stopped at "
              f"{run.logs.stop_iter}, {blocks} blocks run; launches "
              f"fused_mlp_fwd {launches[0]}, fused_mlp_hidden {launches[1]} "
              f"(expected {want[0]}, {want[1]}); {wall:.2f} s in all")
        if cfg.use_pallas != "auto" or run.model.use_pallas is not True:
            failures.append("single run: use_pallas='auto' did not pick the "
                            "kernel on this card")
        if cfg.n_iter != 20_000:
            failures.append(f"single run: n_iter {cfg.n_iter}, not the "
                            f"preset's 20,000")
        if launches != want:
            failures.append(f"single run: launches {launches}, expected "
                            f"{want} for {blocks} blocks, stopped at "
                            f"{run.logs.stop_iter}")
        _against_anchor(run, failures, card)
        _check_csvs(run.paths["metrics"], failures)

        t0 = time.perf_counter()
        model, params = load_model(
            os.path.join(run.paths["models"], "model"), run.case,
            device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        served = load_predictor(run.paths["predictor"], device="cuda")
    x, c = run.data_test[:2]
    got_y = served(x, c, seed=SEED)["y"]
    want_y = Predictor(dataclasses.replace(model, use_pallas=False), params,
                       cfg, device="cuda")(x, c, seed=SEED)["y"]
    worst = float(np.abs(got_y - want_y).max())
    ok = np.allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
    print(f"single run --export_serving: the artifact loaded on the card, y "
          f"at {cfg.n_test} points x {cfg.n_mc_test} MC, seed {SEED}, vs the "
          f"checkpoint's plain Predictor: max_abs_err {worst:.3e} (rtol "
          f"{RTOL} atol {ATOL}) {'ok' if ok else 'MISMATCH'}; export "
          f"{run.seconds['export']:.3f} s")
    if not ok:
        failures.append("single run: the serving artifact disagrees with the "
                        "checkpoint's plain Predictor")
    outputs = tuple(SAMPLE_SLOTS)
    x, c = run.data_test[:2]
    got = Predictor(model, params, cfg, outputs=outputs, device="cuda")(
        x, c, seed=SEED)
    want_out = Predictor(run.model, run.params, cfg, outputs=outputs,
                         device="cuda")(x, c, seed=SEED)
    same = all(np.array_equal(got[o], want_out[o]) for o in outputs)
    worst = max(float(np.abs(got[o] - want_out[o]).max()) for o in outputs)
    print(f"single run: load_model's Predictor vs the in-memory model, "
          f"{len(outputs)} outputs at {cfg.n_test} points x {cfg.n_mc_test} "
          f"MC, seed {SEED}: {'equal' if same else 'DIFFERENT'} (max abs "
          f"difference {worst:.3e})")
    if not same:
        failures.append("single run: the restored model's predictions "
                        "differ from the in-memory model's")

    for name, m in run.metrics.items():
        print(f"single run metrics {name}: R2 {m['R2'].tolist()} MSE "
              f"{m['MSE'].tolist()} MAE {m['MAE'].tolist()}")
        if not all(np.isfinite(m[k]).all() for k in ("R2", "MSE", "MAE")):
            failures.append(f"single run: {name}'s metrics are not finite")
    print(f"single run MLP baseline (scikit-learn's fit, {card}): "
          f"{mlp_epochs.summary()}; {run.seconds['MLP']:.3f} s")
    if set(run.metrics) != {"LIN", "GPR", "MLP", cfg.name}:
        failures.append(f"single run: metrics of {sorted(run.metrics)}")
    r2_f64 = _lstsq_r2(run.data_train, run.data_test)
    lin_gap = float(np.abs(run.metrics["LIN"]["R2"] - r2_f64).max())
    print(f"single run: LIN R2 {run.metrics['LIN']['R2'].tolist()} vs "
          f"float64 lstsq {r2_f64.tolist()}: |difference| {lin_gap:.3e} "
          f"(tolerance {LSTSQ_TOL})")
    if not lin_gap <= LSTSQ_TOL:
        failures.append("single run: LIN's R2 is off float64 least squares")

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    t0 = time.perf_counter()
    evaluate_model(cfg, run.case, run.model, run.params, run.data_test)
    eval_s = time.perf_counter() - t0
    eval_launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    print(f"single run: evaluate_model at {cfg.n_test} points x "
          f"{cfg.n_mc_test} MC: launches fused_mlp_fwd {eval_launches[0]}, "
          f"fused_mlp_hidden {eval_launches[1]} (expected 0, 0: y needs no "
          f"decoder_x); {1e3 * eval_s:.1f} ms")
    if eval_launches != (0, 0):
        failures.append("single run: evaluate_model launched a kernel")

    stages = {**run.seconds, "load": load_s}
    print(f"single run stage wall times ({card}): " + ", ".join(
        f"{name} {s:.3f} s" for name, s in stages.items()))

    from dpivae_tpu_torch.eval import probes

    for regressor, kwargs in (("linear", None),
                              ("mlp_jax", dict(n_epochs=PROBE_EPOCHS)),
                              ("mlp", None)):
        t0 = time.perf_counter()
        with _EpochRecorder(probes) as epochs:
            rows = disentanglement_metric(
                cfg, run.model, run.params, run.case, run.data_train,
                run.data_test, regressor=regressor,
                generator=torch.Generator(device="cuda").manual_seed(SEED),
                mlp_kwargs=kwargs)
        took = time.perf_counter() - t0
        what = regressor + (f" ({PROBE_EPOCHS} epochs)" if kwargs else "")
        if regressor == "mlp":
            what += f" (scikit-learn's fit: {epochs.summary()})"
        print(f"disentanglement_metric, {what} probes ({card}): "
              f"{took:.3f} s; " +
              ", ".join(f"{b}/{f} {r:.4f}" for b, f, r in rows))
        if len(rows) != 3 * len(run.case.factors) or not all(
                np.isfinite(r[2]) for r in rows):
            failures.append(f"disentanglement_metric ({regressor}): rows "
                            f"missing or not finite")
    print(f"phase 8 wall ({card}): {time.perf_counter() - phase_t0:.1f} s")
    return launches, run


def _figure_specs(params, cfg, case, cond, predictions_only):
    """Each figure that ``single_run --plots`` draws from data on the
    device, as figure name -> (forward launches expected, a function of
    the model that computes the figure's data as a list of tensors), with
    the seeds ``single_run`` gives them; only the two prediction figures
    when ``predictions_only``."""
    from dpivae_tpu_torch.viz import visualization as viz

    n_plot, n_interp = cfg.n_plot, cfg.n_interp
    factors = range(len(case.factors))
    seed = cfg.seed + 5

    def pred(model, idx, key):
        return list(viz.pred_decomposition(
            model, params, cfg, case, idx, n_interp, n_plot, cond, key,
            device="cuda")[0].values())

    def post(model, indices):
        return [t for idx in indices for t in viz.marginal_post_data(
            model, params, cfg, case, idx, n_interp, n_plot, cond, seed,
            device="cuda")[0]]

    specs = {f"fig_pred_x_{idx}": (n_interp, lambda m, idx=idx: pred(
        m, idx, seed)) for idx in factors}
    specs["fig_pred_interp_x"] = (n_interp * len(factors), lambda m: [
        t for idx in factors for t in pred(m, idx, viz.fold_in(seed, idx))])
    if predictions_only:
        return specs
    specs["fig_post_marginal_z"] = (0, lambda m: post(m, factors))
    specs["fig_post_marginal_z_01"] = (0, lambda m: post(m, (0, 1)))
    specs["fig_prior_marginal_z"] = (0, lambda m: [
        t for idx in factors for t in viz.marginal_prior_data(
            m, params, cfg, case, idx, n_interp, n_plot, seed,
            device="cuda")[0]])
    specs["fig_posterior_ground_truth"] = (0, lambda m: list(
        viz.ground_truth_posterior_data(m, params, cfg, case, case.gt_dist(),
                                        n_plot, cond, seed, device="cuda")))
    return specs


def _figure_data(ops, failures, card, what, model, params, cfg, case,
                 cond=False, predictions_only=False):
    """The figures' data on the card (phase 13): each figure's data from
    ``model`` (counted and timed) and from a use_pallas=False copy of it
    under the same seeds, held against each other. Returns the forward
    launches of the kernel model's figures."""
    plain = dataclasses.replace(model, use_pallas=False)
    specs = _figure_specs(params, cfg, case, cond, predictions_only)
    total, worst_all, rows = 0, 0.0, []
    for name, (want_launches, fn) in specs.items():
        torch.cuda.synchronize()
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        got = fn(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
        t0 = time.perf_counter()
        want = fn(plain)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(torch.allclose(g, w, rtol=RTOL, atol=ATOL)
                 for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        total += launches[0]
        worst_all = max(worst_all, worst)
        rows.append(f"{name} {1e3 * wall:.1f} ms (plain {1e3 * plain_wall:.1f}"
                    f" ms), launches {launches[0]}/{launches[1]}, max_abs_err "
                    f"{worst:.3e}")
        if launches != (want_launches, 0):
            failures.append(f"figure data {what} {name}: launches {launches}, "
                            f"expected ({want_launches}, 0)")
        if not ok or not finite:
            failures.append(f"figure data {what} {name}: kernel and plain "
                            f"disagree or not finite")
    print(f"figure data {what} ({card}; n_plot {cfg.n_plot}, n_interp "
          f"{cfg.n_interp}; kernel model wall per figure, fused_mlp_fwd/"
          f"hidden launches, max_abs_err vs use_pallas=False, rtol {RTOL} "
          f"atol {ATOL}): " + "; ".join(rows))
    print(f"figure data {what}: {total} forward launches in all, max_abs_err "
          f"{worst_all:.3e}")
    return total


def _figures(ops, failures, card, run):
    """Phase 13: every figure's data of the single run's trained
    simple_beam / "dpivae" model ("auto": the kernel), then the
    prediction figures' data of bridge / "DPIVAE-A" (P model, cond) with
    random weights and use_pallas=True."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.train import init_params, setup_model
    from dpivae_tpu_torch.utils.data import sample_response

    cfg = run.config
    if (cfg.n_plot, cfg.n_interp) != (2_000, 5):
        failures.append(f"figure data: n_plot {cfg.n_plot}, n_interp "
                        f"{cfg.n_interp}, not the config's 2,000 and 5")
    launches = _figure_data(ops, failures, card, "simple_beam / 'dpivae'",
                            run.model, run.params, cfg, run.case)
    case = get_case("bridge")
    cfg = TrainConfig().with_preset(case.presets["DPIVAE-A"]).replace(
        use_pallas=True, use_seed=True, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data = sample_response(case, gen, cfg.n_train, sample_dist=case.gt_dist(),
                           device="cuda")
    model = setup_model(cfg, case, data, device="cuda")
    params = init_params(cfg, model, device="cuda")
    launches += _figure_data(ops, failures, card, "bridge / 'DPIVAE-A'",
                             model, params, cfg, case, cond=True,
                             predictions_only=True)
    return launches


def _decode_options(ops, failures, card):
    """remat_decode with the kernel, and bf16 with "auto" (phase 9).
    Returns the (forward, hidden) launches of the two runs together."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("simple_beam")
    base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9,
        n_iter=N_ITER_DECODE_OPTIONS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, base.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, base.n_val,
                               sample_dist=case.gt_dist(), device="cuda")

    def train(cfg, params=None, warm=False):
        """A counted run of cfg from the seeds; with ``warm``, after a
        N_ITER_WARM-step run of the same model, so that the timed run
        carries no first-step costs (phase 6 times a warm run too)."""
        model = setup_model(cfg, case, data_train, device="cuda")
        if params is None:
            params = init_params(cfg, model, device="cuda")
        if warm:
            train_model(cfg.replace(n_iter=N_ITER_WARM), model, case,
                        data_train, data_val, params=params,
                        generator=torch.Generator(device="cuda"),
                        device="cuda")
            torch.cuda.synchronize()
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        _, logs = train_model(cfg, model, case, data_train, data_val,
                              params=params, generator=g, device="cuda")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        return (model, params, logs, took,
                (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches))

    n = base.n_iter
    total = [0, 0]
    remat_cfg = base.replace(use_pallas=True, remat_decode=True)
    model, params, logs, took, launches = train(remat_cfg, warm=True)
    want = (2 * n + n // base.val_freq, n)
    total = [a + b for a, b in zip(total, launches)]
    _, _, plain_logs, _, _ = train(remat_cfg.replace(remat_decode=False),
                                   params)
    got = logs.train[:N_ROWS_COMPARED]
    ref = plain_logs.train[:N_ROWS_COMPARED]
    worst = float((got - ref).abs().max())
    print(f"remat_decode, use_pallas=True ({card}): {n} steps in "
          f"{took:.2f} s ({n / took:.1f} steps/s, warm: after a "
          f"{N_ITER_WARM}-step run); launches fused_mlp_fwd "
          f"{launches[0]}, fused_mlp_hidden {launches[1]} (expected "
          f"{want[0]}, {want[1]}); first {N_ROWS_COMPARED} rows vs "
          f"remat_decode=False max_abs_err {worst:.3e} (rtol {TRAIN_TOL} "
          f"atol {TRAIN_TOL})")
    if launches != want or not model.remat_decode:
        failures.append(f"remat_decode: launches {launches}, expected {want}")
    if not torch.allclose(got, ref, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append("remat_decode: the first train rows disagree with "
                        "remat_decode=False")
    if not torch.isfinite(logs.train).all():
        failures.append("remat_decode: a log row is not finite")

    bf16_cfg = base.replace(use_pallas="auto", compute_dtype="bfloat16")
    model, _, logs, took, launches = train(bf16_cfg, params, warm=True)
    total = [a + b for a, b in zip(total, launches)]
    finite = bool(torch.isfinite(logs.train).all()
                  and torch.isfinite(logs.val).all())
    _, elbo_val = logs.scalars("ELBO_val")
    print(f"compute_dtype='bfloat16', use_pallas='auto' ({card}): resolved "
          f"to {model.use_pallas}; {n} steps in {took:.2f} s "
          f"({n / took:.1f} steps/s, warm); launches fused_mlp_fwd "
          f"{launches[0]}, "
          f"fused_mlp_hidden {launches[1]} (expected 0, 0); log rows "
          f"{'finite' if finite else 'NOT FINITE'}; ELBO_val "
          f"{elbo_val[0]:.4f} -> {elbo_val[-1]:.4f}")
    if launches != (0, 0) or model.use_pallas:
        failures.append(f"bf16: launches {launches}, expected none")
    if not finite:
        failures.append("bf16: a log row is not finite")
    return tuple(total)


def _batched_bound_ms(members, rows, d_in, d_hidden, d_out, hidden=False):
    """The least time of one member-batched launch: every member's x and
    output, and its own weights, moved once; the operations of all
    members' rows. For the forward, layer 2 on the TF32 tensor cores in
    three passes (the kernel's bound, as ``_bound_ms``); for the hidden
    kernel, f32 on the CUDA cores (as ``_hidden_bound_ms``)."""
    total = members * rows
    if hidden:
        flops = 2 * total * d_hidden * (d_in + 1)
        n_bytes = 4 * (total * (d_in + d_hidden)
                       + members * (d_hidden * d_in + d_hidden))
        t_ops = flops / F32_FLOPS_PER_S
    else:
        layer1 = 2 * total * d_in * d_hidden
        layer2 = 2 * total * d_hidden * d_out
        n_bytes = 4 * (total * (d_in + d_out) + members * (
            d_hidden * d_in + d_hidden + d_out * d_hidden + d_out))
        t_ops = max(3 * layer2 / TF32_FLOPS_PER_S, layer1 / F32_FLOPS_PER_S)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _batched_kernels(ops, failures):
    """The member-batched kernels against the batched plain version
    (torch.baddbmm, ReLU, torch.baddbmm: also the batched library pair) on
    the same inputs, at the sweep's shapes; and FusedMLPFunction's
    backward under vmap(grad) against vmap(grad) of the plain version.
    Each batched call must be one launch."""
    m = SWEEP_MEMBERS
    results = {}
    for name, rows in (("training", 1_024), ("validation", 32_768)):
        f = _randn(SEED + 50)
        args = (f(m, rows, 8), f(m, 128, 8) * 0.3, f(m, 128) * 0.1,
                f(m, 64, 128) * 0.3, f(m, 64) * 0.1)
        with torch.inference_mode():
            before = ops.fused_mlp.launches
            got = ops.fused_mlp(*args)
            one = ops.fused_mlp.launches - before
            want = ops.fused_mlp_reference(*args)
            torch.cuda.synchronize()
            max_abs = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            ms = _device_ms(lambda: ops.fused_mlp(*args), reps=10)
            plain_ms = _device_ms(lambda: ops.fused_mlp_reference(*args),
                                  reps=10)
        bound_ms, bound_by = _batched_bound_ms(m, rows, 8, 128, 64)
        print(f"batched kernel {name} {m} members x {rows} rows x "
              f"(8->128->64), one launch ({one}): max_abs_err "
              f"{max_abs:.3e} (rtol {RTOL} atol {ATOL}) "
              f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms, batched "
              f"plain = library pair (baddbmm + ReLU + baddbmm) "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f} % of it reached)")
        if not ok or one != 1:
            failures.append(f"the batched forward at {name}: agrees {ok}, "
                            f"{one} launches for one call")
        results[f"forward_{name}"] = dict(max_abs_err=max_abs, ms=ms,
                                          plain_ms=plain_ms,
                                          bound_ms=bound_ms)

    f = _randn(SEED + 51)
    args = (f(m, 1_024, 8), f(m, 128, 8) * 0.3, f(m, 128) * 0.1)
    with torch.inference_mode():
        before = ops.fused_mlp_hidden.launches
        got = ops.fused_mlp_hidden(*args)
        one = ops.fused_mlp_hidden.launches - before
        want = ops.fused_mlp_hidden_reference(*args)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        ms = _device_ms(lambda: ops.fused_mlp_hidden(*args), reps=10)
        plain_ms = _device_ms(
            lambda: ops.fused_mlp_hidden_reference(*args), reps=10)
    bound_ms, bound_by = _batched_bound_ms(m, 1_024, 8, 128, 64, hidden=True)
    print(f"batched hidden kernel training {m} members x 1024 rows x "
          f"(8->128), one launch ({one}): max_abs_err {max_abs:.3e} "
          f"{'ok' if ok else 'MISMATCH'}; kernel {ms:.4f} ms, batched plain "
          f"= library (baddbmm + ReLU) {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by})")
    if not ok or one != 1:
        failures.append(f"the batched hidden kernel: agrees {ok}, {one} "
                        f"launches for one call")
    results["hidden_training"] = dict(max_abs_err=max_abs, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms)

    f = _randn(SEED + 52)
    args = (f(m, 1_024, 8), f(m, 128, 8) * 0.3, f(m, 128) * 0.1,
            f(m, 64, 128) * 0.3, f(m, 64) * 0.1)
    # The cotangent of a loss averaged over the rows, as the training
    # loss is: unscaled, dW1's sums of 1,024 O(1) terms differ by ~3e-5
    # between two summation orders, over the absolute tolerance.
    g = f(m, 1_024, 64) / 1_024

    def grads(mlp):
        loss = lambda x, w0, b0, w1, b1, g: torch.sum(mlp(x, w0, b0, w1, b1)
                                                      * g)
        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))

    kernel_fn, plain_fn = grads(ops.fused_mlp), grads(ops.fused_mlp_reference)
    before = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    got = kernel_fn(*args, g)
    one = (ops.fused_mlp.launches - before[0],
           ops.fused_mlp_hidden.launches - before[1])
    want = plain_fn(*args, g)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("dx", "dw0", "db0", "dw1", "db1"), got, want):
        max_abs = max(max_abs, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL):
            failures.append(f"vmap(grad) through FusedMLPFunction: {name} "
                            f"disagrees with the plain version")
    if one != (1, 1):
        failures.append(f"vmap(grad) through FusedMLPFunction launched "
                        f"{one} (forward, hidden), expected one each")
    ms = _device_ms(lambda: kernel_fn(*args, g), reps=10, inner=3)
    plain_ms = _device_ms(lambda: plain_fn(*args, g), reps=10, inner=3)
    print(f"vmap(grad) through FusedMLPFunction, {m} members x 1024 rows x "
          f"(8->128->64): launches (forward, hidden) {one}; five gradients "
          f"max_abs_err {max_abs:.3e} (rtol {GRAD_RTOL} atol {GRAD_ATOL}); "
          f"forward + backward {ms:.4f} ms, plain under vmap(grad) "
          f"{plain_ms:.4f} ms")
    results["vmap_grad"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return results


def _sweep(ops, failures, card):
    """train_sweep at bench.py's sweep workload, "auto" (plain) and
    use_pallas=True, each timed after a warm-up. Returns the (forward,
    hidden) launches of the counted use_pallas=True run, the member-steps/s
    and phase 17 (c)'s inputs (config, case, the "auto" result, the
    members' training sets, a test set's x and c for every member)."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.sweep import member_datasets, train_sweep
    from dpivae_tpu_torch.train import setup_model, train_model
    from dpivae_tpu_torch.train.setup import make_template_model
    from dpivae_tpu_torch.train.train import member_generators
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("damped_oscillator")
    base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9, n_iter=N_ITER_SWEEP)
    lambdas = torch.linspace(-1.0, 1.0, SWEEP_MEMBERS).tolist()
    runs, times, launches = {}, {}, {}
    for name, use_pallas in (("auto", "auto"), ("kernel", True)):
        cfg = base.replace(use_pallas=use_pallas)
        train_sweep(cfg.replace(n_iter=N_ITER_WARM), case, lambdas,
                    seed=SEED + 1, device="cuda")
        torch.cuda.synchronize()
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        runs[name] = train_sweep(cfg, case, lambdas, seed=SEED,
                                 device="cuda")
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = (ops.fused_mlp.launches,
                          ops.fused_mlp_hidden.launches)
    n = N_ITER_SWEEP
    want = {"auto": (0, 0), "kernel": (n + n // base.val_freq, n)}
    for name in runs:
        logs = runs[name].logs
        rate = SWEEP_MEMBERS * n / times[name]
        print(f"sweep damped_oscillator / 'dpivae', use_pallas "
              f"{'auto' if name == 'auto' else True} ({card}): "
              f"{SWEEP_MEMBERS} members x {n} steps in one chunk in "
              f"{times[name]:.2f} s (warm): {rate:.1f} member-steps/s; "
              f"launches fused_mlp_fwd {launches[name][0]}, fused_mlp_hidden "
              f"{launches[name][1]} (expected {want[name][0]}, "
              f"{want[name][1]})")
        if launches[name] != want[name]:
            failures.append(f"sweep ({name}): launches {launches[name]}, "
                            f"expected {want[name]}")
        active = logs.train[logs.train_active]
        if not (torch.isfinite(active).all()
                and torch.isfinite(logs.val[logs.val_active]).all()):
            failures.append(f"sweep ({name}): an active log row is not "
                            f"finite")
        if not bool(logs.train_active.all()):
            failures.append(f"sweep ({name}): a member stopped early")
    kernel, auto = runs["kernel"].logs.train, runs["auto"].logs.train
    spread = float((kernel[:, -1, 0] - kernel[0, -1, 0]).abs().max())
    if not spread > 0:
        failures.append("sweep: every member ended with the same ELBO")
    worst = float((kernel[:, :N_ROWS_COMPARED]
                   - auto[:, :N_ROWS_COMPARED]).abs().max())
    print(f"sweep: use_pallas=True vs 'auto' first {N_ROWS_COMPARED} rows of "
          f"all members max_abs_err {worst:.3e} (rtol {TRAIN_TOL} atol "
          f"{TRAIN_TOL}); final ELBO spread over members {spread:.4f}")
    if not torch.allclose(kernel[:, :N_ROWS_COMPARED],
                          auto[:, :N_ROWS_COMPARED], rtol=TRAIN_TOL,
                          atol=TRAIN_TOL):
        failures.append("sweep: use_pallas=True and 'auto' disagree")

    # One member as a single run: its data, init and generator.
    member = SWEEP_MEMBERS // 3
    cfg = base.replace(use_pallas=True, lambda_g0=lambdas[member],
                       n_iter=N_ROWS_COMPARED)
    g = member_generators(SEED, [member], "cuda")[0]
    data_train, data_val = member_datasets(cfg, case, None, generator=g)
    params = make_template_model(cfg, case, device="cuda").init(g,
                                                                device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    _, single = train_model(cfg, model, case, data_train, data_val,
                            params=params, generator=g, device="cuda")
    got = kernel[member, :N_ROWS_COMPARED]
    worst = float((got - single.train).abs().max())
    print(f"sweep member {member} vs a single train_model run of its data, "
          f"init and generator: first {N_ROWS_COMPARED} rows max_abs_err "
          f"{worst:.3e} (rtol {TRAIN_TOL} atol {TRAIN_TOL})")
    if not torch.allclose(got, single.train, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append("sweep: a member disagrees with its single run")
    _profile_sweep_step(base.replace(use_pallas=True), case, lambdas)
    # Phase 17 (c)'s inputs: the "auto" sweep, each member's training set
    # (its scalers') and one test set of n_test points for every member.
    res = runs["auto"]
    rows = [member_datasets(base, case, k, "cuda")[0] for k in res.keys]
    dtr = tuple(torch.stack([r[k] for r in rows]) for k in range(3))
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    test = sample_response(case, g, base.n_test, sample_dist=case.gt_dist(),
                           device="cuda")
    x, c = (a.expand(SWEEP_MEMBERS, *a.shape) for a in test[:2])
    return launches["kernel"], {k: SWEEP_MEMBERS * n / t
                                for k, t in times.items()}, (
        base.replace(use_pallas="auto"), case, res, dtr, x, c)


def _member_run(cfg, case, lambdas, data=None):
    """A ``MemberTrainer`` of len(lambdas) members and their generators:
    each member's datasets from its generator, or ``data``, the stacked
    (train, val) of a data sweep."""
    from dpivae_tpu_torch.sweep.sweep import _generators, _keys, \
        _member_start
    from dpivae_tpu_torch.train.setup import make_template_model
    from dpivae_tpu_torch.train.train import MemberTrainer, stack_params

    gens = _generators(_keys(SEED, range(len(lambdas))), "cuda")
    template = make_template_model(cfg, case, device="cuda")
    starts = [_member_start(cfg, case, template, g, None if data is None
                            else tuple(tuple(a[j] for a in d[:3])
                                       for d in data))
              for j, g in enumerate(gens)]
    stack = lambda k: tuple(torch.stack([s[k][c] for s in starts])
                            for c in range(3))
    run = MemberTrainer(cfg, case, stack_params([s[2] for s in starts]),
                        stack(0), stack(1), torch.tensor(lambdas,
                                                         device="cuda"))
    return run, gens


def _profile_sweep_step(cfg, case, lambdas, data=None):
    """torch.profiler's view of one warm member-batched train step, of
    len(lambdas) members (``_member_run``)."""
    from torch.profiler import ProfilerActivity, profile

    m = len(lambdas)
    run, gens = _member_run(cfg, case, lambdas, data)
    for i in range(5):
        run.step(i, generators=gens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5, 15):
        run.step(i, generators=gens)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(15, generators=gens)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    _print_profile(f"one batched train step of {m} {case.name} / "
                   f"{cfg.name!r} ({run.template.model_type} model) members",
                   events, wall_ms, step_ms)
    for kernel in ("fused_mlp_fwd_kernel", "fused_mlp_hidden_kernel"):
        _per_launch(events, kernel, f"{m} x 1024 rows")


def _study(ops, failures, card):
    """The disentanglement study in process, then its resumes. Returns the
    (forward, hidden) launches of the calls and the seconds of each call's
    latents stage."""
    import csv
    import tempfile

    from dpivae_tpu_torch.eval import probes
    from dpivae_tpu_torch.scripts import disentanglement_metric as study
    from dpivae_tpu_torch.train import train as train_mod

    steps = [0]
    step = train_mod.MemberTrainer.step

    def counted(self, *args, **kwargs):
        steps[0] += 1
        return step(self, *args, **kwargs)

    train_mod.MemberTrainer.step = counted
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    total = [0, 0]
    try:
        with tempfile.TemporaryDirectory(dir=root) as out:
            argv = ["--case", "damped_oscillator", "--n_iter",
                    str(N_ITER_STUDY), "--regressor", "linear", "--output",
                    out, "--device", "cuda"]
            calls = []
            mlp = argv[:argv.index("--regressor") + 1] + ["mlp"] + argv[
                argv.index("--regressor") + 2:]
            # trained; resumed; resumed with scikit-learn's MLP probes
            for args in (argv, argv, mlp):
                steps[0] = 0
                ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
                t0 = time.perf_counter()
                with _EpochRecorder(probes) as epochs:
                    run = study.main(args)
                wall = time.perf_counter() - t0
                launched = (ops.fused_mlp.launches,
                            ops.fused_mlp_hidden.launches)
                total = [a + b for a, b in zip(total, launched)]
                with open(os.path.join(run.path,
                                       "disentanglement_score.csv")) as f:
                    rows = list(csv.reader(f))
                calls.append((run, rows, steps[0], launched, wall, epochs))
            files = sorted(os.listdir(run.path))
    finally:
        train_mod.MemberTrainer.step = step
    (first, rows, n_steps, launched, wall, _), second = calls[0], calls[1]
    n_members = first.result.n_members
    want_rows = n_members * len(first.case.factors) * 3
    scores = [float(r[2]) for r in rows[1:]]
    print(f"study damped_oscillator / 'dpivae' ({card}): {n_members} "
          f"members (11 λ x 6 runs), {N_ITER_STUDY} steps, linear probes: "
          f"{len(rows) - 1} score rows (expected {want_rows}: "
          f"{len(first.case.factors)} factors x 3 blocks per member), "
          f"{n_steps} eager batched steps (the rest replayed), launches "
          f"{launched}; {wall:.2f} s; "
          f"stages " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in first.timings.items()))
    print(f"study files: {files[:6]} ... ({len(files)} entries)")
    if (tuple(rows[0]) != study.SCORE_COLUMNS or len(rows) - 1 != want_rows
            or not all(map(math.isfinite, scores)) or first.failures):
        failures.append("study: score rows missing, mis-headed or not "
                        "finite")
    by_block = {}
    for r in rows[1:]:
        by_block.setdefault((r[0], r[1]), []).append(float(r[2]))
    print("study mean R² by (block, factor): " + ", ".join(
        f"{b}/{f} {sum(v) / len(v):.3f}" for (b, f), v in by_block.items()))
    run2, rows2, n_steps2, launched2, wall2, _ = second
    print(f"study resumed on the same output: {n_steps2} batched steps, "
          f"launches {launched2}, scores "
          f"{'identical' if rows2 == rows else 'DIFFERENT'}; {wall2:.2f} s; "
          f"stages " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in run2.timings.items()))
    if n_steps2 or launched2 != (0, 0) or rows2 != rows:
        failures.append("study: the resumed call trained or changed scores")
    run3, rows3, n_steps3, launched3, wall3, epochs = calls[2]
    scores3 = [float(r[2]) for r in rows3[1:]]
    print(f"study resumed with --regressor mlp (scikit-learn's "
          f"MLPRegressor(128, 128) fit, {card}): {n_steps3} batched steps, "
          f"launches {launched3}, {len(scores3)} score rows "
          f"{'finite' if all(map(math.isfinite, scores3)) else 'NOT FINITE'}"
          f"; probes: {epochs.summary()}; {wall3:.2f} s; stages " + ", ".join(
              f"{k} {v:.3f} s" for k, v in run3.timings.items()))
    by_block = {}
    for r in rows3[1:]:
        by_block.setdefault((r[0], r[1]), []).append(float(r[2]))
    print("study (mlp probes) mean R² by (block, factor): " + ", ".join(
        f"{b}/{f} {sum(v) / len(v):.3f}" for (b, f), v in by_block.items()))
    if (n_steps3 or launched3 != (0, 0) or len(scores3) != want_rows
            or not all(map(math.isfinite, scores3)) or run3.failures
            or len(epochs.n_iter) != want_rows):
        failures.append("study: the --regressor mlp resume trained, "
                        "launched, or wrote rows missing or not finite")
    return tuple(total), [call[0].timings["latents"] for call in calls]


class _EpochRecorder:
    """Records the epochs (``n_iter``) of every ``fit_mlp_sklearn`` call
    made through ``module``'s name for it, while in a ``with`` block."""

    def __init__(self, module):
        self.module, self.n_iter = module, []

    def __enter__(self):
        self.fit = self.module.fit_mlp_sklearn

        def recorded(*args, **kwargs):
            out = self.fit(*args, **kwargs)
            self.n_iter.extend(out.n_iter.tolist())
            return out

        self.module.fit_mlp_sklearn = recorded
        return self

    def __exit__(self, *exc):
        self.module.fit_mlp_sklearn = self.fit

    def summary(self) -> str:
        n = self.n_iter
        if not n:
            return "no fit"
        return (f"{len(n)} fits, epochs median {statistics.median(n):g}, "
                f"range {min(n)}-{max(n)}")


def _per_request_times(predictors, x, c):
    """Warm per-request wall times (ms) of each named predictor, over
    N_TIMED_REQUESTS requests taken in rotating turns."""
    times = {name: [] for name in predictors}
    for p in predictors.values():
        for _ in range(3):
            p(x, c, seed=0)
    names = list(predictors)
    for i in range(N_TIMED_REQUESTS):
        for name in names[i % len(names):] + names[:i % len(names)]:
            t0 = time.perf_counter()
            predictors[name](x, c, seed=i)  # returns numpy: a device sync
            times[name].append(1e3 * (time.perf_counter() - t0))
    return times


def _compare(what, got, want, failures, rtol=RTOL, atol=ATOL):
    """Max abs error of two dicts of numpy outputs; a failure if any output
    is outside rtol/atol or not finite."""
    import numpy as np

    worst = 0.0
    for name in want:
        worst = max(worst, float(np.abs(got[name] - want[name]).max()))
        if not (np.isfinite(got[name]).all()
                and np.allclose(got[name], want[name], rtol=rtol, atol=atol)):
            failures.append(f"{what}: {name} disagrees")
    return worst


def _artifact(ops, failures, card, setup, request):
    """The serving artifact (phase 11). Returns the forward launches of the
    live kernel Predictor's counted requests, and the loaded simple_beam
    artifact."""
    import tempfile
    import warnings

    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import bridge as bridge_module
    from dpivae_tpu_torch.serving import (
        SAMPLE_SLOTS,
        Predictor,
        load_predictor,
        save_predictor,
    )
    from dpivae_tpu_torch.train import init_params, setup_model
    from dpivae_tpu_torch.utils.data import sample_response

    cfg, case, model, params = setup
    outputs = tuple(SAMPLE_SLOTS)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as out:
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            path = save_predictor(os.path.join(out, "beam.pt2"), model,
                                  params, cfg, case, outputs=outputs)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_predictor(path, device="cuda")
        load_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
    warned = sum("use_pallas=True" in str(w.message) for w in caught)
    print(f"artifact simple_beam / 'dpivae' (use_pallas=True model, "
          f"{len(outputs)} outputs, {cfg.n_mc_test} MC): exported on the CPU "
          f"in {export_s:.2f} s ({warned} warning that it runs the plain "
          f"decode), {size_mb:.2f} MB, loaded on the card in {load_s:.2f} s; "
          f"torch {served.meta['torch_version']}")
    if warned != 1 or served.device.type != "cuda":
        failures.append(f"artifact: {warned} use_pallas warnings, device "
                        f"{served.device}")
    kernel = Predictor(model, params, cfg, outputs=outputs, device="cuda")
    plain = Predictor(dataclasses.replace(model, use_pallas=False), params,
                      cfg, outputs=outputs, device="cuda")
    x, c = request
    launches = {"artifact": 0, "kernel": 0}
    for size in (1, 7, cfg.n_test):
        xs, cs = x[:size], c[:size]
        answers = {}
        for name, p in (("artifact", served), ("kernel", kernel),
                        ("plain", plain)):
            before = ops.fused_mlp.launches
            answers[name] = p(xs, cs, seed=size)
            if name in launches:
                launches[name] += ops.fused_mlp.launches - before
        if any(v.shape[0] != size for v in answers["artifact"].values()):
            failures.append(f"artifact: wrong batch at {size} points")
        err_plain = _compare(f"artifact vs plain Predictor at {size} points",
                             answers["artifact"], answers["plain"], failures)
        err_kernel = _compare(f"artifact vs kernel Predictor at {size} "
                              f"points", answers["artifact"],
                              answers["kernel"], failures)
        print(f"artifact request of {size} points x {cfg.n_mc_test} MC, seed "
              f"{size}: max_abs_err vs the live plain Predictor "
              f"{err_plain:.3e}, vs the live kernel Predictor "
              f"{err_kernel:.3e} (rtol {RTOL} atol {ATOL})")
    print(f"artifact launches over the 3 requests: artifact "
          f"{launches['artifact']} (expected 0), live kernel Predictor "
          f"{launches['kernel']} (expected 3)")
    if launches != {"artifact": 0, "kernel": 3}:
        failures.append(f"artifact: launches {launches}")
    times = _per_request_times(
        {"artifact": served, "plain": plain, "kernel": kernel}, x, c)
    for name, t in times.items():
        q1, q2, q3 = statistics.quantiles(t, n=4)
        print(f"per request {cfg.n_test} x {cfg.n_mc_test} MC ({card}), "
              f"{name}: median "
              f"{q2:.3f} ms, quartiles {q1:.3f}-{q3:.3f} ms over "
              f"{N_TIMED_REQUESTS} requests (rotating turns)")

    # bridge / "DPIVAE-A" with cond, exported before any eager call: a
    # fresh case whose partial-physics surrogate has decoded nothing.
    fresh = bridge_module.build.__wrapped__()
    b_cfg = TrainConfig().with_preset(fresh.presets["DPIVAE-A"]).replace(
        use_seed=True, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    data = sample_response(fresh, gen, b_cfg.n_train,
                           sample_dist=fresh.gt_dist(), device="cuda")
    b_model = setup_model(b_cfg, fresh, data, device="cuda")
    b_params = init_params(b_cfg, b_model, device="cuda")
    cold = not fresh.part_model._copies
    with tempfile.TemporaryDirectory(dir=root) as out:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            path = save_predictor(os.path.join(out, "bridge.pt2"), b_model,
                                  b_params, b_cfg, fresh, cond=True,
                                  outputs=outputs)
        still_cold = not fresh.part_model._copies
        b_served = load_predictor(path, device="cuda")
    xb, cb = sample_response(fresh, gen, b_cfg.n_test,
                             sample_dist=fresh.gt_dist(), device="cuda")[:2]
    live = Predictor(dataclasses.replace(b_model, use_pallas=False), b_params,
                     b_cfg, cond=True, outputs=outputs, device="cuda")
    err = _compare("bridge artifact (cond) vs its live Predictor",
                   b_served(xb, cb, seed=SEED), live(xb, cb, seed=SEED),
                   failures)
    print(f"artifact bridge / 'DPIVAE-A' (P model), cond=True, exported "
          f"before any eager call (surrogate cache empty before {cold}, "
          f"after {still_cold}): {b_cfg.n_test} points x {b_cfg.n_mc_test} "
          f"MC vs its live plain Predictor max_abs_err {err:.3e} (rtol "
          f"{RTOL} atol {ATOL})")
    if not (cold and still_cold):
        failures.append("artifact: the export left constants in the "
                        "surrogate's cache")
    return launches["kernel"], served


def _transfer(ops, failures, card):
    """The transfer study in process, its resume, a member's artifact, then
    the use_pallas=True grid on the same datasets (phase 12). Returns the
    (forward, hidden) launches of the counted runs, the grid's
    member-steps/s and its inputs (config, case, λs, datasets), phase 17
    (c)'s inputs (the grid's use_pallas=True config, case and result, its
    training sets, the test sets' x and c) and the seconds of each call's
    predict stages."""
    import csv
    import tempfile

    import numpy as np

    from dpivae_tpu_torch.eval import baselines
    from dpivae_tpu_torch.scripts import regression_comparison as transfer
    from dpivae_tpu_torch.serving import Predictor, load_predictor
    from dpivae_tpu_torch.sweep import (
        auto_chunk_size,
        export_member_predictor,
        member_model,
        train_sweep_data,
    )
    from dpivae_tpu_torch.train import setup_model, train_model
    from dpivae_tpu_torch.train import train as train_mod
    from dpivae_tpu_torch.train.setup import make_template_model
    from dpivae_tpu_torch.train.train import member_config, member_generators

    steps = [0]
    step = train_mod.MemberTrainer.step

    def counted(self, *args, **kwargs):
        steps[0] += 1
        return step(self, *args, **kwargs)

    train_mod.MemberTrainer.step = counted
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    total = [0, 0]
    calls = []
    try:
        with tempfile.TemporaryDirectory(dir=root) as out:
            argv = ["--case", "bridge", "--dist_type", "extrapolation",
                    "--n_runs", str(TRANSFER_RUNS),
                    "--n_iter", str(N_ITER_TRANSFER), "--output", out,
                    "--device", "cuda"]
            jax = ["--baselines", "jax"]
            # batched baselines; resumed without them; resumed with the
            # default (sklearn) baselines
            for extra in (jax, jax + ["--skip_baselines"], []):
                steps[0] = 0
                ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
                t0 = time.perf_counter()
                with _EpochRecorder(baselines) as epochs:
                    run = transfer.main(argv + extra)
                wall = time.perf_counter() - t0
                launched = (ops.fused_mlp.launches,
                            ops.fused_mlp_hidden.launches)
                total = [a + b for a, b in zip(total, launched)]
                with open(os.path.join(run.path, "metrics",
                                       "raw_metrics.csv")) as f:
                    rows = list(csv.reader(f))
                with open(os.path.join(run.path, "metrics", "table.tex")) as f:
                    tex = f.read()
                with open(os.path.join(run.path, "timings.json")) as f:
                    timings = json.load(f)
                calls.append((run, rows, tex, timings, steps[0], launched,
                              wall, epochs))
            # One member of the "DPIVAE-A" grid as a serving artifact
            first = calls[0][0]
            member = 5
            data_train = tuple(a[member] for a in first.data[0])
            cfg_a = first.config.with_preset(first.case.presets["DPIVAE-A"])
            path = export_member_predictor(
                cfg_a, first.case, first.results["DPIVAE-A"], member,
                os.path.join(out, "member.pt2"), data_train=data_train,
                outputs=("y", "zx"))
            served = load_predictor(path, device="cuda")
    finally:
        train_mod.MemberTrainer.step = step
    (run, rows, tex, timings, n_steps, launched, wall, _) = calls[0]
    case = run.case
    n_members = TRANSFER_RUNS * transfer.N_DOMAINS
    want_rows = n_members * 5
    body = rows[1:]
    finite = all(math.isfinite(float(v)) for r in body for v in r[3:])
    models = {r[2] for r in body}
    print(f"transfer study bridge extrapolation ({card}): {n_members} members "
          f"per preset ({TRANSFER_RUNS} runs x 4 domains), {N_ITER_TRANSFER} "
          f"steps, --baselines jax: {len(body)} rows (expected {want_rows}), "
          f"{'finite' if finite else 'NOT FINITE'}, models {sorted(models)}; "
          f"{n_steps} eager batched steps (the rest replayed); launches "
          f"{launched} (expected (0, 0): "
          f"'auto' is plain in sweeps); {wall:.2f} s; stages " + ", ".join(
              f"{k} {v:.3f} s" for k, v in timings.items()))
    if (tuple(rows[0]) != transfer.CSV_COLUMNS or len(body) != want_rows
            or not finite or models != {"DPIVAE-A", "DPIVAE-B", "GPR", "LIN",
                                         "MLP"}):
        failures.append("transfer: raw_metrics.csv rows missing, mis-headed "
                        "or not finite")
    if launched != (0, 0):
        failures.append(f"transfer: 'auto' launched {launched}")
    if tex.count("\\begin{table}") != 2 or "(avg over domains)" not in tex:
        failures.append("transfer: table.tex lacks its two tables")
    phases = {"device_init", "train_DPIVAE-A", "predict_DPIVAE-A",
              "train_DPIVAE-B", "predict_DPIVAE-B", "baselines", "total"}
    if set(timings) != phases:
        failures.append(f"transfer: timings.json phases {sorted(timings)}")
    by_model = {}
    for r in body:
        by_model.setdefault(r[2], []).append(float(r[3]))
    print(f"transfer mean R² over {n_members} folds after {N_ITER_TRANSFER} "
          f"steps (BASELINE.md's JAX study after 20,000 steps beside it, for "
          f"reference): " + ", ".join(
              f"{k} {np.mean(v):.3f} ± {np.std(v, ddof=1):.3f} "
              f"({TRANSFER_R2_REFERENCE[k]})"
              for k, v in sorted(by_model.items())))
    run2, rows2, _, timings2, n_steps2, launched2, wall2, _ = calls[1]
    same = rows2[1:] == [r for r in body if r[2].startswith("DPIVAE")]
    print(f"transfer resumed on the same output (--skip_baselines): "
          f"{n_steps2} batched steps, launches {launched2}, DPIVAE rows "
          f"{'identical' if same else 'DIFFERENT'}; {wall2:.2f} s; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in timings2.items()))
    if n_steps2 or launched2 != (0, 0) or not same:
        failures.append("transfer: the resumed call trained, launched or "
                        "changed rows")
    _, rows3, _, timings3, n_steps3, launched3, wall3, epochs3 = calls[2]
    body3 = rows3[1:]
    key = lambda r: tuple(r[:3])
    by_key = {key(r): r for r in body}
    finite3 = all(math.isfinite(float(v)) for r in body3 for v in r[3:])
    same3 = [r for r in body3 if r[2].startswith("DPIVAE")] == [
        r for r in body if r[2].startswith("DPIVAE")]
    lin_gap = max(abs(float(a) - float(b)) for r in body3 if r[2] == "LIN"
                  for a, b in zip(r[3:], by_key[key(r)][3:]))
    gpr, mlp = ({name: [float(r[3]) for r in rows_ if r[2] == model]
                 for name, rows_ in (("sklearn", body3), ("jax", body))}
                for model in ("GPR", "MLP"))
    print(f"transfer resumed with the default --baselines sklearn: "
          f"{n_steps3} batched steps, launches {launched3}, {len(body3)} rows "
          f"{'finite' if finite3 else 'NOT FINITE'}, DPIVAE rows "
          f"{'identical' if same3 else 'DIFFERENT'}, LIN rows vs --baselines "
          f"jax max_abs_err {lin_gap:.3e} (atol 1e-4); baselines "
          f"{timings3.get('baselines', float('nan')):.3f} s, {wall3:.2f} s "
          f"in all; GPR mean R² sklearn (float64 L-BFGS-B) " + ", ".join(
              f"{k} {np.mean(v):.3f} ± {np.std(v, ddof=1):.3f}"
              for k, v in gpr.items())
          + f" (BASELINE.md {TRANSFER_R2_REFERENCE['GPR']})")
    print(f"transfer MLP baseline ({card}): --baselines sklearn "
          f"(MLPRegressor(64, 64)'s rules, all members at once) "
          f"{epochs3.summary()}; mean R² " + ", ".join(
              f"{k} {np.mean(v):.3f} ± {np.std(v, ddof=1):.3f}"
              for k, v in mlp.items())
          + f" (BASELINE.md {TRANSFER_R2_REFERENCE['MLP']}); baselines "
          f"stage {timings3.get('baselines', float('nan')):.3f} s")
    if len(epochs3.n_iter) != n_members:
        failures.append(f"transfer: the sklearn MLP fitted "
                        f"{len(epochs3.n_iter)} members, expected "
                        f"{n_members}")
    if (n_steps3 or launched3 != (0, 0) or not same3 or not finite3
            or len(body3) != want_rows or not lin_gap <= 1e-4):
        failures.append("transfer: the default-baselines call trained, "
                        "launched, changed DPIVAE rows or LIN rows, or "
                        "wrote rows missing or not finite")

    model, params = member_model(cfg_a, case, run.results["DPIVAE-A"], member,
                                 data_train=data_train)
    x, c = (a[member] for a in run.data[2][:2])
    live = Predictor(model, params, member_config(cfg_a),
                     outputs=("y", "zx"), device="cuda")
    err = _compare("member artifact vs member_model's Predictor",
                   served(x, c, seed=SEED), live(x, c, seed=SEED), failures)
    print(f"export_member_predictor, member {member} of the 'DPIVAE-A' grid: "
          f"y and zx at {x.shape[0]} points x {cfg_a.n_mc_test} MC vs "
          f"member_model's Predictor max_abs_err {err:.3e} (rtol {RTOL} atol "
          f"{ATOL}); sidecar lambda_g0 {served.meta['lambda_g0']}")

    # The same 24 "DPIVAE-A" datasets through the member-batched kernels
    dtr, dva = run.data[0], run.data[1]
    base = cfg_a.replace(n_iter=N_ITER_TRANSFER_KERNEL, patience=10**9)
    lambdas = [base.lambda_g0] * n_members
    chunk = auto_chunk_size(n_members, member_config(base), case, "cuda")
    n_chunks = -(-n_members // chunk)
    results, times, counts = {}, {}, {}
    for name, use_pallas in (("auto", "auto"), ("kernel", True)):
        cfg = base.replace(use_pallas=use_pallas)
        train_sweep_data(cfg.replace(n_iter=N_ITER_WARM), case, lambdas, dtr,
                         dva, seed=SEED + 1, device="cuda")
        torch.cuda.synchronize()
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        results[name] = train_sweep_data(cfg, case, lambdas, dtr, dva,
                                         seed=SEED, device="cuda")
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[name] = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    n = N_ITER_TRANSFER_KERNEL
    want = {"auto": (0, 0),
            "kernel": (n_chunks * (n + n // base.val_freq), n_chunks * n)}
    for name in results:
        logs = results[name].logs
        print(f"transfer grid bridge / 'DPIVAE-A' (P model), use_pallas "
              f"{'auto' if name == 'auto' else True} ({card}): {n_members} "
              f"members in {n_chunks} chunk(s) of {chunk} x {n} steps in "
              f"{times[name]:.2f} s (warm): {n_members * n / times[name]:.1f} "
              f"member-steps/s; launches {counts[name]} (expected "
              f"{want[name]})")
        if counts[name] != want[name]:
            failures.append(f"transfer grid ({name}): launches "
                            f"{counts[name]}, expected {want[name]}")
        if not (torch.isfinite(logs.train[logs.train_active]).all()
                and torch.isfinite(logs.val[logs.val_active]).all()):
            failures.append(f"transfer grid ({name}): a log row is not "
                            f"finite")
    kernel_rows = results["kernel"].logs.train[:, :N_ROWS_COMPARED]
    auto_rows = results["auto"].logs.train[:, :N_ROWS_COMPARED]
    worst = float((kernel_rows - auto_rows).abs().max())
    print(f"transfer grid: use_pallas=True vs 'auto' first {N_ROWS_COMPARED} "
          f"rows of all members max_abs_err {worst:.3e} (rtol {TRAIN_TOL} "
          f"atol {TRAIN_TOL})")
    if not torch.allclose(kernel_rows, auto_rows, rtol=TRAIN_TOL,
                          atol=TRAIN_TOL):
        failures.append("transfer grid: use_pallas=True and 'auto' disagree")
    m = n_members // 3
    cfg1 = base.replace(use_pallas=True, n_iter=N_ROWS_COMPARED)
    g = member_generators(SEED, [m], "cuda")[0]
    p0 = make_template_model(cfg1, case, device="cuda").init(g, device="cuda")
    member_data = [tuple(a[m] for a in d[:3]) for d in (dtr, dva)]
    single_model = setup_model(cfg1, case, member_data[0], device="cuda")
    _, single = train_model(cfg1, single_model, case, *member_data, params=p0,
                            generator=g, device="cuda")
    worst = float((results["kernel"].logs.train[m, :N_ROWS_COMPARED]
                   - single.train).abs().max())
    print(f"transfer grid member {m} vs a single train_model run of its data, "
          f"init and generator: first {N_ROWS_COMPARED} rows max_abs_err "
          f"{worst:.3e} (rtol {TRAIN_TOL} atol {TRAIN_TOL})")
    if not torch.allclose(results["kernel"].logs.train[m, :N_ROWS_COMPARED],
                          single.train, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append("transfer grid: a member disagrees with its single "
                        "run")
    _profile_sweep_step(base.replace(use_pallas=True), case, lambdas,
                        data=(dtr, dva))
    predict_walls = [(f"{k[len('predict_'):]} (call {i + 1})", call[3][k])
                     for i, call in enumerate(calls)
                     for k in ("predict_DPIVAE-A", "predict_DPIVAE-B")]
    sampling = (base.replace(use_pallas=True), case, results["kernel"],
                dtr, *run.data[2][:2])
    return tuple(a + b for a, b in zip(total, counts["kernel"])), {
        k: n_members * n / t for k, t in times.items()}, (
        base, case, lambdas, dtr, dva), sampling, predict_walls


def _max_diff(got, want) -> float:
    """The largest |got - want| over tensors or state dicts, NaN rows
    (past an early stop) compared as equal."""
    if isinstance(got, dict):
        return max(_max_diff(got[k], want[k]) for k in want)
    if isinstance(got, (tuple, list)):
        return max(_max_diff(a, b) for a, b in zip(got, want))
    a, b = got.detach().float(), want.detach().float()
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return math.inf
    return float((a - b).nan_to_num().abs().max()) if a.numel() else 0.0


def _mesh_train(ops, failures, card, mesh):
    """Phase 14 (b): train_model over the one-rank "dp" mesh, its block
    graph replayed with the NCCL all-reduces captured, against the same
    mesh's eager loop (bit for bit) and the graphed run without the mesh
    (within RTOL / ATOL), launches counted, steps/s of all three in
    turns, and a profile of one replayed data-parallel block. Returns its
    launches."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.train.train import Trainer
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9, n_iter=N_ITER_MESH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    params = init_params(cfg, model, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    modes = {"mesh": (True, "auto"), "mesh eager": (True, False),
             "no mesh": (False, "auto")}

    def run(mode, n_iter=N_ITER_MESH):
        use_mesh, cuda_graph = modes[mode]
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _LoopCounts() as counts:
            out = train_model(cfg.replace(n_iter=n_iter), model, case,
                              data_train, data_val, params=params,
                              generator=g, device="cuda",
                              mesh=mesh if use_mesh else None,
                              cuda_graph=cuda_graph)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts

    for mode in modes:
        run(mode, N_ITER_WARM)
    results, times, launches = {}, {mode: [] for mode in modes}, None
    for mode in modes:
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        results[mode], seconds, counts = run(mode)
        times[mode].append(seconds)
        if mode == "mesh":
            launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
            _check_loop("data-parallel simple_beam (one-rank NCCL mesh)",
                        counts, results[mode][1], cfg, failures, launches)
    for mode in reversed(list(modes)):
        times[mode].append(run(mode)[1])
    n = N_ITER_MESH
    (mesh_params, mesh_logs), (eager_params, eager_logs), \
        (plain_params, plain_logs) = (results[m] for m in modes)
    own = max(_max_diff(mesh_logs, eager_logs),
              _max_diff(mesh_params.state_dict(), eager_params.state_dict()))
    worst = max(_max_diff(mesh_logs, plain_logs),
                _max_diff(mesh_params.state_dict(), plain_params.state_dict()))
    print(f"mesh train_model simple_beam / 'dpivae' ({card}): {n} steps "
          f"over {mesh}, use_pallas {cfg.use_pallas!r} resolved to "
          f"{model.use_pallas}; params and logs, the block graph against "
          f"the mesh's eager loop: max_abs_err {own:.3e} (expected 0); "
          f"against the graphed run without the mesh: max_abs_err "
          f"{worst:.3e} (rtol {RTOL} atol {ATOL})")
    if own != 0:
        failures.append(f"mesh train_model: the block graph differs from "
                        f"the mesh's eager loop by {own:.3e}")
    ok = all(torch.allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
             for a, b in zip(mesh_logs, plain_logs)) and all(
        torch.allclose(a, b, rtol=RTOL, atol=ATOL) for a, b in zip(
            mesh_params.state_dict().values(),
            plain_params.state_dict().values()))
    if not ok or mesh_logs.stop_iter != n:
        failures.append("mesh train_model: params or logs differ from the "
                        "run without the mesh")
    print(f"mesh train_model steps/s ({card}), warm runs in turns "
          + ", ".join(modes) + ", then back: " + "; ".join(
              f"{mode} " + " / ".join(f"{n / t:.1f}" for t in times[mode])
              for mode in modes))

    # One warm data-parallel block, replayed, under the profiler.
    trainer = Trainer(cfg, case, params, data_train, data_val,
                      cfg.lambda_g0, mesh=mesh)
    _, _, events, prof = _profile_block(
        trainer, torch.Generator(device="cuda").manual_seed(SEED + 2),
        "data-parallel (one-rank NCCL mesh)")
    nccl = [e for e in events if "nccl" in e.key.lower()]
    copies = [e for e in events if "memcpy" in e.key.lower()]
    host = [e for e in prof.key_averages()
            if "allreduce" in e.key.lower().replace("_", "")
            and not e.is_user_annotation]
    print(f"profile: NCCL device kernels in the replayed block: "
          f"{sum(e.count for e in nccl)}, "
          f"{sum(e.self_device_time_total for e in nccl) / 1e3:.4f} ms "
          + (f"({', '.join(e.key[:60] for e in nccl)})" if nccl else
             "(none: one rank's all-reduce launches no kernel)")
          + f"; memcpys {sum(e.count for e in copies)}, "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.4f} ms ("
          + ", ".join(f"{e.key[:40]} x{e.count}" for e in copies)
          + "); host all-reduce ops in the replay: " + (", ".join(
              f"{e.key} x{e.count}" for e in host) or "none")
          + f"; one all-reduce a step of {n_params} params + 8 log "
          f"components = {4 * (n_params + 8)} bytes, one a validation")
    return launches


def _mesh_sweep(ops, failures, card):
    """Phase 14 (c): a member-sharded sweep over a one-rank "sweep" mesh
    against the unsharded sweep. Returns its launches."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.parallel import make_mesh
    from dpivae_tpu_torch.sweep import train_sweep

    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_pallas=True, use_seed=True, seed=SEED, patience=10**9,
        n_iter=N_ITER_MESH_SWEEP)
    lambdas = torch.linspace(-1.0, 1.0, SWEEP_MEMBERS).tolist()
    mesh = make_mesh(1, ("sweep",))
    train_sweep(cfg.replace(n_iter=N_ITER_WARM), case, lambdas, seed=SEED,
                device="cuda", mesh=mesh)

    def run(use_mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_sweep(cfg, case, lambdas, seed=SEED, device="cuda",
                          mesh=mesh if use_mesh else None)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    sharded, t_sharded = run(True)
    launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    plain, t_plain = run(False)
    n = N_ITER_MESH_SWEEP
    want = (n + n // cfg.val_freq, n)
    worst = max(_max_diff(sharded.logs, plain.logs),
                _max_diff(sharded.params, plain.params))
    rate = lambda t: SWEEP_MEMBERS * n / t
    print(f"mesh sweep damped_oscillator / 'dpivae' ({card}): "
          f"{SWEEP_MEMBERS} members x {n} steps over {mesh}, use_pallas "
          f"True: launches fused_mlp_fwd {launches[0]}, fused_mlp_hidden "
          f"{launches[1]} (expected {want[0]}, {want[1]}); against the "
          f"unsharded sweep max_abs_err {worst:.3e} (rtol {RTOL} atol "
          f"{ATOL}); member-steps/s sharded {rate(t_sharded):.1f}, "
          f"unsharded {rate(t_plain):.1f}")
    if launches != want:
        failures.append(f"mesh sweep: launches {launches}, expected {want}")
    if (sharded.params.keys() != plain.params.keys() or not all(
            torch.allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
            for a, b in zip((*sharded.logs, *sharded.params.values()),
                            (*plain.logs, *plain.params.values())))):
        failures.append("mesh sweep: the sharded sweep differs from the "
                        "unsharded one")
    return launches


def _mesh_study(ops, failures, card):
    """Phase 14 (d): the study with --n_devices 1 against the study
    without the flag, at phase 10's sizes cut to N_ITER_MESH_SWEEP steps.
    Returns the launches of both calls."""
    import tempfile

    from dpivae_tpu_torch.scripts import disentanglement_metric as study

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    argv = ["--case", "damped_oscillator", "--n_iter",
            str(N_ITER_MESH_SWEEP), "--regressor", "linear", "--device",
            "cuda"]
    texts, walls = {}, {}
    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    with tempfile.TemporaryDirectory(dir=root) as out:
        for name, extra in (("plain", []), ("mesh", ["--n_devices", "1"])):
            t0 = time.perf_counter()
            run = study.main(argv + ["--output", os.path.join(out, name)]
                             + extra)
            walls[name] = time.perf_counter() - t0
            with open(os.path.join(run.path,
                                   "disentanglement_score.csv")) as f:
                texts[name] = f.read()
            n_rows = len(texts[name].splitlines()) - 1
            stages = ", ".join(f"{k} {v:.3f} s" for k, v in
                               run.timings.items())
            print(f"mesh study ({name}, {card}): {run.result.n_members} "
                  f"members, {N_ITER_MESH_SWEEP} steps, {n_rows} score rows, "
                  f"{walls[name]:.2f} s; stages {stages}")
    launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    same = texts["mesh"] == texts["plain"] and n_rows > 0
    print(f"mesh study: disentanglement_score.csv with --n_devices 1 "
          f"{'identical to' if same else 'DIFFERENT from'} the run without "
          f"the flag; launches {launches} ('auto' is plain in sweeps)")
    if not same:
        failures.append("mesh study: --n_devices 1 changed the scores")
    return launches


def _mesh(ops, failures, card):
    """Phase 14: the device mesh on the card. Returns the (forward,
    hidden) launches of its paths."""
    import torch.distributed as dist

    from dpivae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, ("dp",))
    try:
        backend = dist.get_backend()
        print(f"mesh ({card}): make_mesh(1, ('dp',)) -> {mesh}, process "
              f"group backend {backend}, world size {dist.get_world_size()}")
        if backend != "nccl" or mesh.device != torch.device("cuda", 0):
            failures.append(f"mesh: backend {backend} on {mesh.device}, "
                            f"expected nccl on cuda:0")
        train = _mesh_train(ops, failures, card, mesh)
        sweep = _mesh_sweep(ops, failures, card)
        studies = _mesh_study(ops, failures, card)
    finally:
        mesh.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return tuple(a + b + c for a, b, c in zip(train, sweep, studies))


# ----------------------------------------------------------------------
# Phase 15: the decode's options in sweeps, a CNN-encoder model, and the
# three example programs
# ----------------------------------------------------------------------

def _step_peak_mb(step):
    """(peak, peak above the allocation before it) of one warm train step,
    the call ``step()``, in MB: torch.cuda.max_memory_allocated, reset
    just before."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e6, (peak - before) / 1e6


def _allocations_at_peak(step, top=6):
    """The allocations live when one call of ``step()`` peaks, from the
    caching allocator's recorded history (``torch.cuda.memory``): the
    trace's alloc and free events replayed from the call's start. Returns
    (peak MB above the start, [(MB, count, where), ...] largest first),
    ``where`` the innermost frame in the port (or the innermost frame)."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        step()
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, peak, at_peak = {}, 0, 0, {}
    for event in snapshot["device_traces"][0]:
        if event["action"] == "alloc":
            live[event["addr"]] = event
            total += event["size"]
        elif event["action"] == "free_completed" and event["addr"] in live:
            total -= live.pop(event["addr"])["size"]
        if total > peak:
            peak, at_peak = total, dict(live)

    def where(event):
        frames = event.get("frames") or []
        ours = [f for f in frames if "dpivae_tpu_torch" in f["filename"]]
        f = (ours or frames or [{"filename": "?", "line": 0, "name": "?"}])[0]
        return (f"{f['filename'].split('dpivae_tpu_torch/')[-1]}:"
                f"{f['line']} {f['name']}")

    groups = {}
    for event in at_peak.values():
        key = where(event)
        size, count = groups.get(key, (0, 0))
        groups[key] = (size + event["size"], count + 1)
    ranked = sorted(((size / 1e6, count, key)
                     for key, (size, count) in groups.items()), reverse=True)
    return peak / 1e6, ranked[:top]


def _widened_case(width):
    """simple_beam with its physics replaced by a width-``width`` tanh MLP
    of two hidden layers and random weights x 0.1, as
    benchmarks/experiments/scaling.py's ``widened_case`` builds the JAX
    package's scaled cells; the data's full model is untouched."""
    import numpy as np

    from dpivae_tpu_torch.cases import Surrogate, get_case

    base = get_case("simple_beam")
    d_in = base.nz_x + len(base.idx_c_phys)
    rng = np.random.default_rng(width)
    sizes = [d_in, width, width, base.nd_x]
    layers = tuple(
        {"w": (0.1 * rng.uniform(-1, 1, (a, b)) * math.sqrt(6 / (a + b)))
         .astype(np.float32), "b": np.zeros(b, np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:]))
    surrogate = Surrogate(params={"layers": layers},
                          scaler_mean=np.zeros(d_in, np.float32),
                          scaler_scale=np.ones(d_in, np.float32))
    return dataclasses.replace(base, part_model=surrogate)


def _remat_memory(ops, failures, card):
    """remat_decode's memory at the JAX package's w1024_b1024_mc64 cell
    (docs/PERFORMANCE.md:208-209: 703 MB of peak HBM with remat against
    970 MB without): one single-run train step of the widened simple_beam,
    with and without remat, unchunked and in MC_CHUNKS_REMAT chunks.
    Chunked, remat's peak above the step's start must be lower. Returns
    the (forward, hidden) launches of the counted steps."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.train import init_params, setup_model
    from dpivae_tpu_torch.train.train import Trainer
    from dpivae_tpu_torch.utils.data import sample_response

    case = _widened_case(REMAT_WIDTH)
    base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, hidden_width=REMAT_WIDTH, n_batch=1024,
        n_mc_train=REMAT_MC, n_train=1024)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data_train = sample_response(case, gen, base.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, base.n_val,
                               sample_dist=case.gt_dist(), device="cuda")
    params = init_params(base, setup_model(base, case, data_train,
                                           device="cuda"), device="cuda")
    chunked = REMAT_MC // MC_CHUNKS_REMAT  # samples per chunk
    total, peaks = [0, 0], {}
    for chunk in (None, chunked):
        for remat in (True, False):
            cfg = base.replace(mc_chunk=chunk, remat_decode=remat)
            run = Trainer(cfg, case, copy.deepcopy(params), data_train,
                          data_val, cfg.lambda_g0)
            g = torch.Generator(device="cuda").manual_seed(SEED + 1)
            run.step(0, generator=g)  # the warm-up: Adam's state exists
            ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
            peak, above = _step_peak_mb(lambda: run.step(1, generator=g))
            launched = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
            total = [a + b for a, b in zip(total, launched)]
            n_chunks = 1 if chunk is None else MC_CHUNKS_REMAT
            # "auto" is plain here: the decoder's hidden width is outside
            # the kernel's band
            want = (((2 if remat else 1) * n_chunks, n_chunks)
                    if run.model.use_pallas else (0, 0))
            peaks[chunk, remat] = above
            print(f"remat cell w{REMAT_WIDTH}_b1024_mc{REMAT_MC}, "
                  f"remat_decode={remat}, mc_chunk {chunk} ({card}): one "
                  f"train step's torch.cuda.max_memory_allocated {peak:.1f} "
                  f"MB, {above:.1f} MB above the step's start; use_pallas "
                  f"'auto' resolved to {run.model.use_pallas}, launches "
                  f"{launched} (expected {want})")
            if launched != want:
                failures.append(f"remat cell (mc_chunk {chunk}, remat "
                                f"{remat}): launches {launched}, expected "
                                f"{want}")
            if chunk is None:
                at_peak, ranked = _allocations_at_peak(
                    lambda: run.step(2, generator=g))
                print(f"  allocations live at that step's peak "
                      f"({at_peak:.1f} MB above its start), by the "
                      f"innermost frame of the port: " + "; ".join(
                          f"{mb:.1f} MB x{n} {where}"
                          for mb, n, where in ranked))
            del run
    print(f"remat cell ({card}): peak above the step's start, unchunked "
          f"{peaks[None, True]:.1f} MB with remat vs {peaks[None, False]:.1f} "
          f"MB without (JAX package, whole program: 703 vs 970 MB); "
          f"{MC_CHUNKS_REMAT} chunks {peaks[chunked, True]:.1f} vs "
          f"{peaks[chunked, False]:.1f} MB")
    if not peaks[chunked, True] < peaks[chunked, False]:
        failures.append(f"remat cell: in {MC_CHUNKS_REMAT} MC chunks remat's "
                        f"peak {peaks[chunked, True]:.1f} MB is not below "
                        f"{peaks[chunked, False]:.1f} MB")
    return tuple(total)


def _sweep_decode_options(ops, failures, card):
    """remat_decode in phase 10's 66-member sweep with the kernels, against
    the same sweep without it, then the sweep in bf16 with "auto". Returns
    the (forward, hidden) launches of the counted runs."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.sweep import train_sweep

    case = get_case("damped_oscillator")
    base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9,
        n_iter=N_ITER_SWEEP_OPTIONS, use_pallas=True)
    lambdas = torch.linspace(-1.0, 1.0, SWEEP_MEMBERS).tolist()
    n, vf = base.n_iter, base.val_freq
    configs = {"remat": base.replace(remat_decode=True), "plain": base}
    want = {"remat": (2 * n + n // vf, n), "plain": (n + n // vf, n)}
    for cfg in configs.values():
        train_sweep(cfg.replace(n_iter=N_ITER_WARM), case, lambdas,
                    seed=SEED + 1, device="cuda")
    runs, times, launches = {}, {}, {}
    for name, cfg in configs.items():  # in turns: remat, then plain
        torch.cuda.synchronize()
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        runs[name] = train_sweep(cfg, case, lambdas, seed=SEED,
                                 device="cuda")
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = (ops.fused_mlp.launches,
                          ops.fused_mlp_hidden.launches)
        print(f"sweep damped_oscillator / 'dpivae', use_pallas=True, "
              f"remat_decode={name == 'remat'} ({card}): {SWEEP_MEMBERS} "
              f"members x {n} steps in {times[name]:.2f} s (warm): "
              f"{SWEEP_MEMBERS * n / times[name]:.1f} member-steps/s; "
              f"launches fused_mlp_fwd {launches[name][0]}, "
              f"fused_mlp_hidden {launches[name][1]} (expected "
              f"{want[name][0]}, {want[name][1]})")
        if launches[name] != want[name]:
            failures.append(f"sweep {name}: launches {launches[name]}, "
                            f"expected {want[name]}")
        logs = runs[name].logs
        if not (torch.isfinite(logs.train).all()
                and torch.isfinite(logs.val).all()):
            failures.append(f"sweep {name}: a log row is not finite")
    remat, plain = runs["remat"], runs["plain"]
    rows = float((remat.logs.train[:, :N_ROWS_COMPARED]
                  - plain.logs.train[:, :N_ROWS_COMPARED]).abs().max())
    params = max(float((remat.params[k] - v).abs().max())
                 for k, v in plain.params.items())
    print(f"sweep remat_decode vs without: first {N_ROWS_COMPARED} rows of "
          f"all members max_abs_err {rows:.3e} (rtol {TRAIN_TOL} atol "
          f"{TRAIN_TOL}); params after {n} steps max_abs_diff {params:.3e}")
    if not torch.allclose(remat.logs.train[:, :N_ROWS_COMPARED],
                          plain.logs.train[:, :N_ROWS_COMPARED],
                          rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append("sweep: remat_decode disagrees with the plain "
                        "decode")

    # Memory: what remat is for. One warm batched step of each, whole
    # and in MC chunks of MC_CHUNK_MEMORY samples.
    for mc_chunk in (None, MC_CHUNK_MEMORY):
        peaks = {}
        for name, cfg in configs.items():
            run, gens = _member_run(cfg.replace(mc_chunk=mc_chunk), case,
                                    lambdas)
            run.step(0, generators=gens)
            peaks[name] = _step_peak_mb(lambda: run.step(1, generators=gens))
            del run, gens
        print(f"one batched step of {SWEEP_MEMBERS} members, mc_chunk "
              f"{mc_chunk} ({card}), torch.cuda.max_memory_allocated: "
              f"remat_decode {peaks['remat'][0]:.1f} MB "
              f"({peaks['remat'][1]:.1f} MB above the allocation before the "
              f"step), without {peaks['plain'][0]:.1f} MB "
              f"({peaks['plain'][1]:.1f} MB above)")

    bf16 = base.replace(use_pallas="auto", compute_dtype="bfloat16")
    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    t0 = time.perf_counter()
    res = train_sweep(bf16, case, lambdas, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    got = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    finite = bool(torch.isfinite(res.logs.train).all()
                  and torch.isfinite(res.logs.val).all())
    print(f"sweep compute_dtype='bfloat16', use_pallas='auto' ({card}): "
          f"{SWEEP_MEMBERS} members x {n} steps in {took:.2f} s (first "
          f"steps included): {SWEEP_MEMBERS * n / took:.1f} member-steps/s; "
          f"launches {got[0]}, {got[1]} (expected 0, 0); log rows "
          f"{'finite' if finite else 'NOT FINITE'}; final ELBO_val mean "
          f"{float(res.logs.val[:, -1, 0].mean()):.4f} (f32 with the "
          f"kernels {float(plain.logs.val[:, -1, 0].mean()):.4f})")
    if got != (0, 0):
        failures.append(f"bf16 sweep: launches {got}, expected none")
    if not finite:
        failures.append("bf16 sweep: a log row is not finite")
    return tuple(a + b for a, b in zip(launches["remat"], launches["plain"]))


def _cnn_model(ops, failures, card):
    """damped_oscillator / "dpivae" with the Conv1d encoder trunk trained
    with the kernels against use_pallas=False. Returns the kernel run's
    (forward, hidden) launches."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9, n_iter=N_ITER_CNN,
        encoder_x="CNN", use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtr, dva = (sample_response(case, gen, m, sample_dist=case.gt_dist(),
                                device="cuda")
                for m in (cfg.n_train, cfg.n_val))
    logs, launches = {}, {}
    params = None
    for pallas in (True, False):
        run_cfg = cfg.replace(use_pallas=pallas)
        model = setup_model(run_cfg, case, dtr, device="cuda")
        if params is None:
            params = init_params(run_cfg, model, device="cuda")
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        t0 = time.perf_counter()
        _, logs[pallas] = train_model(
            run_cfg, model, case, dtr, dva, params=params,
            generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
            device="cuda")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launches[pallas] = (ops.fused_mlp.launches,
                            ops.fused_mlp_hidden.launches)
        print(f"CNN encoder model damped_oscillator / 'dpivae', use_pallas="
              f"{pallas} ({card}): {cfg.n_iter} steps in {took:.2f} s "
              f"(first steps included); launches {launches[pallas][0]}, "
              f"{launches[pallas][1]}")
    n = cfg.n_iter
    want = (n + n // cfg.val_freq, n)
    got, ref = (logs[p].train[:N_ROWS_COMPARED] for p in (True, False))
    worst = float((got - ref).abs().max())
    _, elbo_val = logs[True].scalars("ELBO_val")
    print(f"CNN encoder model: kernel vs plain first {N_ROWS_COMPARED} rows "
          f"max_abs_err {worst:.3e} (rtol {TRAIN_TOL} atol {TRAIN_TOL}); "
          f"ELBO_val {elbo_val[0]:.4f} -> {elbo_val[-1]:.4f}; launches "
          f"expected {want[0]}, {want[1]}")
    if launches[True] != want or launches[False] != (0, 0):
        failures.append(f"CNN model: launches {launches}")
    if not all(torch.isfinite(lg.train).all() for lg in logs.values()):
        failures.append("CNN model: a log row is not finite")
    if not torch.allclose(got, ref, rtol=TRAIN_TOL, atol=TRAIN_TOL):
        failures.append("CNN model: the kernel run disagrees with plain")
    return launches[True]


def _examples(ops, failures, card, served, request):
    """The custom case, the hyper search and the HTTP host of phase 11's
    artifact (``served``), asked phase 4's ``request``. Returns the
    (forward, hidden) launches of the custom case's run."""
    import concurrent.futures
    import urllib.request

    import numpy as np

    from dpivae_tpu_torch.examples import custom_case, hyper_search, \
        serve_http

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    t0 = time.perf_counter()
    run = custom_case.main(["--n_iter", str(N_ITER_CUSTOM)])
    took = time.perf_counter() - t0
    launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    n = N_ITER_CUSTOM
    want = (n + n // 10, n)
    _, elbo = run.logs.scalars("ELBO")
    r2 = float(np.asarray(run.metrics["cantilever"]["R2"]).reshape(-1)[0])
    print(f"custom_case example ({card}): {n} steps, program {took:.2f} s; "
          f"use_pallas 'auto' launches {launches[0]}, {launches[1]} "
          f"(expected {want[0]}, {want[1]}: the kernels); ELBO "
          f"{elbo[0]:.3f} -> {elbo[-1]:.3f}; damage-label test R2 {r2:.4f}")
    if launches != want:
        failures.append(f"custom_case: launches {launches}, expected {want}")
    if not (np.isfinite(elbo).all() and elbo[-1] < elbo[0]
            and math.isfinite(r2)):
        failures.append("custom_case: the ELBO did not fall or R2 is not "
                        "finite")

    t0 = time.perf_counter()
    search = hyper_search.main(["--n_iter", str(N_ITER_HYPER),
                                "--n_runs", "2"])
    print(f"hyper_search example ({card}): {search.result.n_members} members "
          f"x {N_ITER_HYPER} steps, program {time.perf_counter() - t0:.2f} "
          f"s; ranking {search.order.tolist()}")
    if not np.isfinite(search.final).all():
        failures.append("hyper_search: a final loss is not finite")

    server = serve_http.serve(served, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    try:
        x, c = (a.cpu().numpy() for a in request)
        n_points = x.shape[0]

        def post(seed):
            body = json.dumps({"x": x.tolist(), "c": c.tolist(),
                               "seed": seed}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    url, data=body), timeout=120) as resp:
                out = json.loads(resp.read())
            return ({k: np.asarray(v, np.float32) for k, v in out.items()},
                    1e3 * (time.perf_counter() - t0))

        def direct(seed):
            t0 = time.perf_counter()
            out = served(x, c, seed=seed)
            return out, 1e3 * (time.perf_counter() - t0)

        http_ms, direct_ms, worst = [], [], 0.0
        post(0)
        direct(0)
        for seed in range(N_HTTP_REQUESTS):
            got, ms = post(seed)
            want, d_ms = direct(seed)
            http_ms.append(ms)
            direct_ms.append(d_ms)
            for k, w in want.items():
                worst = max(worst, float(np.abs(got[k] - w).max()))
                if not np.array_equal(got[k], w):
                    failures.append(f"serve_http: {k} at seed {seed} differs "
                                    f"from the direct call")
        serial = [post(100 + i)[0] for i in range(4)]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            concurrent_out = [f.result() for f in [
                pool.submit(post, 100 + i) for i in range(4)]]
        same = all(np.array_equal(a[k], b[0][k]) for a, b in
                   zip(serial, concurrent_out) for k in a)
        print(f"serve_http example ({card}): {N_HTTP_REQUESTS} POSTs of "
              f"{n_points} points x {served.meta['n_mc']} MC, "
              f"{len(served.outputs)} outputs: max_abs_err vs "
              f"ServedPredictor called directly {worst:.3e} (equal "
              f"expected); median wall through HTTP "
              f"{statistics.median(http_ms):.3f} ms, direct "
              f"{statistics.median(direct_ms):.3f} ms; 4 concurrent clients "
              f"{'equal' if same else 'NOT EQUAL'} to serial calls")
        if not same:
            failures.append("serve_http: concurrent answers differ from "
                            "serial ones")
    finally:
        server.shutdown()
        server.server_close()
    return launches


def _phase15(ops, failures, card, served, request):
    """Phase 15. Returns the (forward, hidden) launches of its paths."""
    sweeps = _sweep_decode_options(ops, failures, card)
    remat = _remat_memory(ops, failures, card)
    cnn = _cnn_model(ops, failures, card)
    examples = _examples(ops, failures, card, served, request)
    return tuple(sum(c) for c in zip(sweeps, remat, cnn, examples))


# ----------------------------------------------------------------------
# Phase 16: the graphed training loop against the eager loop
# ----------------------------------------------------------------------

class _LoopCounts:
    """Counts, while it is entered, the training loop's block-graph
    captures and replays and the host's reads of the all-stopped flag
    (``train.train._LaggedFlag.read``)."""

    def __enter__(self):
        from dpivae_tpu_torch.train import train as train_mod

        self.captures = self.replays = self.reads = 0
        counts, self._mod = self, train_mod
        self._saved = (train_mod.Graphed, train_mod._LaggedFlag.read)
        graphed, read = self._saved

        class Counted(graphed):
            def __init__(self, *args, **kwargs):
                counts.captures += 1
                super().__init__(*args, **kwargs)

            def replay(self):
                counts.replays += 1
                return super().replay()

        def counted_read(flag, block):
            counts.reads += 1
            return read(flag, block)

        train_mod.Graphed = Counted
        train_mod._LaggedFlag.read = counted_read
        return self

    def __exit__(self, *exc):
        self._mod.Graphed, self._mod._LaggedFlag.read = self._saved
        return False

    def __repr__(self):
        return (f"{self.captures} capture, {self.replays} replays, "
                f"{self.reads} host reads")


def _blocks_run(logs, cfg) -> int:
    """The blocks the loop ran: every block, or the block at which the
    last run stopped and the one after it (the host reads the flag one
    block behind)."""
    n_blocks = -(-cfg.n_iter // cfg.val_freq)
    live = logs.val_active.reshape(-1, n_blocks).sum(dim=1)
    if bool((live == n_blocks).any()):
        return n_blocks
    return min(int(live.max()) + 1, n_blocks)


def _block_launches(blocks, cfg, forward_per_step=1):
    """(forward, hidden) launches of ``blocks`` validation blocks: each
    block's val_freq steps (their masked steps past n_iter and those
    after a stop included) launch the forward ``forward_per_step`` times
    and the hidden kernel once; its validation launches the forward
    once."""
    vf = cfg.val_freq
    return blocks * (vf * forward_per_step + 1), blocks * vf


def _check_loop(what, counts, logs, cfg, failures, launches=None,
                forward_per_step=1):
    """A graphed run's loop against the block design: one capture when it
    ran more than one block, one replay and one host read a block after
    the first; and, given, its launches against ``_block_launches``."""
    blocks = _blocks_run(logs, cfg)
    want = (int(blocks > 1), blocks - 1, blocks - 1)
    got = (counts.captures, counts.replays, counts.reads)
    print(f"block graph, {what}: {blocks} blocks run, {counts} (expected "
          f"{want[0]} capture, one replay and one host read a block after "
          f"the first: {want[1]}, {want[2]}); graph launches per block "
          f"1, host reads per block 1, one block behind")
    if got != want:
        failures.append(f"block graph ({what}): captures, replays, reads "
                        f"{got}, expected {want}")
    if launches is not None:
        expected = _block_launches(blocks, cfg, forward_per_step)
        print(f"block graph, {what}: launches {launches}, expected "
              f"{expected} = ({blocks} blocks x (val_freq "
              f"{cfg.val_freq} x {forward_per_step} + 1), {blocks} x "
              f"{cfg.val_freq})")
        if tuple(launches) != expected:
            failures.append(f"block graph ({what}): launches {launches}, "
                            f"expected {expected}")
    return blocks


def _graph_pair(what, run, failures, n_timed=0):
    """``run(cuda_graph)`` -> (loop counts, params, logs, launches,
    seconds), once graphed and once eager, then ``n_timed`` warm runs of
    each in turns (eager, graphed, graphed, eager, ...). Prints and checks
    the pair's max_abs_err over rows, validations and params (expected
    0) and returns (graphed result, the seconds of the timed runs by
    loop)."""
    got, want = run(True), run(False)
    worst = max(_max_diff(got[2], want[2]), _max_diff(got[1], want[1]))
    print(f"graph vs eager, {what}: rows, validations and params "
          f"max_abs_err {worst:.3e} (expected 0); stop iteration "
          f"{got[2].stop_iter if got[2].train.dim() == 2 else 'per member'}"
          f"; launches {got[3]} graphed, {want[3]} eager")
    if worst != 0 or got[3] != want[3]:
        failures.append(f"graph vs eager ({what}): max_abs_err {worst:.3e}, "
                        f"launches {got[3]} and {want[3]}")
    times = {True: [], False: []}
    for turn in range(n_timed):
        for graphed in ((False, True) if turn % 2 == 0 else (True, False)):
            times[graphed].append(run(graphed)[4])
    return got, times


def _graph_profile(what, step, first):
    """torch.profiler's view of one warm call ``step(i)`` (a replayed or
    an eager block), after 2 warm calls and 10 timed ones from index
    ``first``. Returns its unprofiled wall per call in ms, the profiled
    device events and the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(first, first + 2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first + 2, first + 12):
        step(i)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(first + 12)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    _print_profile(what, events, wall_ms, step_ms)
    for kernel in ("fused_mlp_fwd_kernel", "fused_mlp_hidden_kernel"):
        _per_launch(events, kernel, what)
    return step_ms, events, prof


def _profile_block(run, generators, what):
    """One eager and one replayed validation block of ``run`` (a Trainer
    or a MemberTrainer whose config has at least 30 blocks, drawing from
    ``generators``: a generator or the members' list), each timed over 10
    blocks after 2 warm ones and then profiled, on the side stream the
    graphed loop uses. Returns (replayed ms, eager ms, the replayed
    block's device events, its profiler)."""
    from dpivae_tpu_torch.train.graph import Graphed, SideStream

    gens = generators if isinstance(generators, list) else [generators]
    body = lambda: run.block_body(generators)

    def eager(i):
        run.block_t.fill_(i)
        body()

    with SideStream(torch.device("cuda")) as stream:
        eager(0)
        eager_ms = _graph_profile(f"one eager {what} block", eager, 1)[0]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = Graphed(body, gens, stream)
        torch.cuda.synchronize()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        pool_mb = (torch.cuda.memory_reserved() - before) / 2**20

        def replay(i):
            run.block_t.fill_(i)
            graph.replay()

        graph_ms, events, prof = _graph_profile(
            f"one replayed {what} block", replay, 15)
    print(f"graphed {what} block: {graph_ms:.3f} ms replayed against "
          f"{eager_ms:.3f} ms eager ({eager_ms / graph_ms:.1f}x), "
          f"{graph_ms / run.config.val_freq:.3f} ms a step; its capture "
          f"took {capture_ms:.1f} ms and reserved {pool_mb:.1f} MiB (its "
          f"pool)")
    return graph_ms, eager_ms, events, prof


def _graph_single(ops, failures, card, setup):
    """Phase 16 (a, b): simple_beam / "dpivae" at bench.py's workload,
    graphed against eager, timed, one replayed block profiled; then an
    early stop at block 1, one in a later block and a partial last block,
    each graphed against eager. Returns the launches of the counted
    graphed runs."""
    from dpivae_tpu_torch.train import train_model
    from dpivae_tpu_torch.train.train import Trainer

    cfg0, case, model, params, data_train, data_val = setup
    cfg = cfg0.replace(n_iter=N_ITER_GRAPH, **GRAPH_ANNEALING)
    total = [0, 0]

    def runner(cfg):
        def run(graphed):
            g = torch.Generator(device="cuda").manual_seed(SEED + 1)
            ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _LoopCounts() as counts:
                p, logs = train_model(cfg, model, case, data_train,
                                      data_val, params=params, generator=g,
                                      device="cuda", cuda_graph=graphed)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            return (counts, p.state_dict(), logs,
                    (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches),
                    seconds)
        return run

    n = cfg.n_iter
    got, times = _graph_pair(
        f"simple_beam / 'dpivae' {n} steps, sigmoid λ and cyclical β_x",
        runner(cfg), failures, GRAPH_TIMED_RUNS)
    logs, launches = got[2], got[3]
    _check_loop("simple_beam", got[0], logs, cfg, failures, launches)
    lam, beta_x = (logs.train[:, c] for c in (8, 9))
    print(f"graphed simple_beam ({card}): λ {float(lam[0]):.3e} -> "
          f"{float(lam[-1]):.3e} ({len(torch.unique(lam))} values), β_x "
          f"{len(torch.unique(beta_x))} values")
    if len(torch.unique(lam)) < 10 or len(torch.unique(beta_x)) < 10:
        failures.append("graphed simple_beam: the schedules did not change")
    total = [a + b for a, b in zip(total, launches)]
    steps_s = {k: statistics.median(n / t for t in v)
               for k, v in times.items()}
    print(f"graphed training steps/s ({card}), simple_beam / 'dpivae' "
          f"use_pallas=True, {n} steps, median of {GRAPH_TIMED_RUNS} warm "
          f"runs in turns: graphed {steps_s[True]:.1f} ("
          + " / ".join(f"{n / t:.1f}" for t in times[True])
          + f"), eager {steps_s[False]:.1f} ("
          + " / ".join(f"{n / t:.1f}" for t in times[False])
          + f"): {steps_s[True] / steps_s[False]:.2f}x")

    trainer = Trainer(cfg, case, copy.deepcopy(params), data_train, data_val,
                      cfg.lambda_g0)
    _profile_block(trainer, torch.Generator(device="cuda").manual_seed(
        SEED + 2), "simple_beam / 'dpivae'")
    print(f"memory: a saved state of simple_beam's params and Adam state "
          f"(the block keeps two, entry and mid, outside the graph's pool) "
          f"{sum(t.numel() * t.element_size() for t in trainer._state)} "
          f"bytes")

    stops = (
        ("at block 1 (a cyclical β_x, 0 at block 0's validation and 10 "
         "at block 1's, and learning rates of 1e-5)", GRAPH_STOP_BLOCK_1,
         N_ITER_GRAPH_STOP_1, 1),
        ("in a later block (patience 1, n_mc_val 1, 10x lr)",
         GRAPH_EARLY_STOP, N_ITER_GRAPH_STOP, None),
        ("none, a partial last block", dict(patience=10**9),
         N_ITER_GRAPH_PARTIAL, None),
    )
    for what, over, n_iter, block in stops:
        stop_cfg = cfg.replace(n_iter=n_iter, **over)
        got, _ = _graph_pair(f"simple_beam early stop {what}, {n_iter} "
                             f"steps", runner(stop_cfg), failures)
        logs = got[2]
        blocks = _check_loop(f"simple_beam, stop {what}", got[0], logs,
                             stop_cfg, failures, got[3])
        stop = logs.stop_iter
        print(f"graphed early stop {what}: stop iteration {stop} (block "
              f"{int(logs.val_active.sum()) - 1}), {blocks} blocks run")
        if n_iter % stop_cfg.val_freq:
            ok = stop == n_iter
        elif block is not None:
            ok = stop == block * stop_cfg.val_freq + 1
        else:
            ok = stop_cfg.val_freq < stop < n_iter
        if not ok:
            failures.append(f"graphed early stop {what}: stop_iter {stop}")
        total = [a + b for a, b in zip(total, got[3])]
    return total


def _graph_members(ops, failures, card, grid):
    """Phase 16 (c, d, e): the 66-member sweep ("auto" and
    use_pallas=True, timed; with per-member early stops), the 24-member
    bridge / "DPIVAE-A" grid, and the remat sweep, each graphed against
    eager. Returns the launches of the counted graphed runs."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.sweep import train_sweep, train_sweep_data

    total = [0, 0]

    def runner(train):
        def run(graphed):
            ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _LoopCounts() as counts:
                res = train(graphed)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            return (counts, res.params, res.logs,
                    (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches),
                    seconds)
        return run

    case = get_case("damped_oscillator")
    base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, seed=SEED, patience=10**9, n_iter=N_ITER_SWEEP,
        **GRAPH_ANNEALING)
    lambdas = torch.linspace(-1.0, 1.0, SWEEP_MEMBERS).tolist()
    sweep = lambda cfg: runner(lambda graphed: train_sweep(
        cfg, case, lambdas, seed=SEED, device="cuda", chunk_size=None,
        cuda_graph=graphed))
    for name, use_pallas in (("auto", "auto"), ("kernel", True)):
        cfg = base.replace(use_pallas=use_pallas)
        got, times = _graph_pair(
            f"{SWEEP_MEMBERS}-member damped_oscillator sweep, use_pallas "
            f"{use_pallas!r}, {N_ITER_SWEEP} steps", sweep(cfg), failures,
            2)
        member_steps = int(got[2].train_active.sum())
        rates = {k: statistics.median(member_steps / t for t in v)
                 for k, v in times.items()}
        _check_loop(f"{SWEEP_MEMBERS}-member sweep ({name})", got[0],
                    got[2], cfg, failures,
                    None if name == "auto" else got[3])
        if name == "auto" and got[3] != (0, 0):
            failures.append(f"graphed sweep (auto): launches {got[3]}, "
                            f"expected none (plain in sweeps)")
        print(f"graphed sweep member-steps/s ({card}), use_pallas "
              f"{use_pallas!r}, median of 2 warm runs in turns: graphed "
              f"{rates[True]:.1f}, eager {rates[False]:.1f} "
              f"({rates[True] / rates[False]:.2f}x)")
        total = [a + b for a, b in zip(total, got[3])]

    stop_cfg = base.replace(use_pallas=True, **GRAPH_EARLY_STOP)
    got, _ = _graph_pair(
        f"{SWEEP_MEMBERS}-member sweep with per-member early stops "
        f"(patience 1, n_mc_val 1, 10x lr)", sweep(stop_cfg), failures)
    stops = got[2].train_active.sum(dim=1)
    n_stopped = int((stops < stop_cfg.n_iter).sum())
    _check_loop(f"{SWEEP_MEMBERS}-member sweep with early stops", got[0],
                got[2], stop_cfg, failures, got[3])
    print(f"graphed sweep early stops: {n_stopped} of {SWEEP_MEMBERS} "
          f"members stopped, at {len(set(stops.tolist()))} iterations "
          f"{sorted(set(stops.tolist()))[:12]}")
    if not 0 < n_stopped or len(set(stops.tolist())) < 2:
        failures.append("graphed sweep: members did not stop at different "
                        "blocks")
    total = [a + b for a, b in zip(total, got[3])]

    remat_cfg = base.replace(use_pallas=True, remat_decode=True,
                             n_iter=N_ITER_SWEEP_OPTIONS)
    got, _ = _graph_pair(
        f"{SWEEP_MEMBERS}-member sweep with remat_decode, "
        f"{N_ITER_SWEEP_OPTIONS} steps", sweep(remat_cfg), failures)
    _check_loop(f"{SWEEP_MEMBERS}-member sweep with remat_decode", got[0],
                got[2], remat_cfg, failures, got[3], forward_per_step=2)
    total = [a + b for a, b in zip(total, got[3])]

    p_cfg, p_case, p_lambdas, dtr, dva = grid
    got, _ = _graph_pair(
        f"{len(p_lambdas)}-member bridge / 'DPIVAE-A' grid (P model), "
        f"use_pallas=True, {p_cfg.n_iter} steps",
        runner(lambda graphed: train_sweep_data(
            p_cfg.replace(use_pallas=True), p_case, p_lambdas, dtr, dva,
            seed=SEED, device="cuda", chunk_size=None, cuda_graph=graphed)),
        failures)
    _check_loop(f"{len(p_lambdas)}-member P grid", got[0], got[2],
                p_cfg, failures, got[3])
    total = [a + b for a, b in zip(total, got[3])]

    run, gens = _member_run(base.replace(use_pallas=True), case, lambdas)
    _profile_block(run, gens, f"{SWEEP_MEMBERS}-member damped_oscillator")
    return total


def _graphs(ops, failures, card, setup, grid):
    """Phase 16. Returns the (forward, hidden) launches of its counted
    graphed runs."""
    single = _graph_single(ops, failures, card, setup)
    members = _graph_members(ops, failures, card, grid)
    return tuple(a + b for a, b in zip(single, members))


# ----------------------------------------------------------------------
# Phase 17: the graphed inference path against the eager one
# ----------------------------------------------------------------------

def _as_tensors(out):
    """Outputs (numpy arrays or tensors, in dicts or lists) as tensors,
    for ``_max_diff``."""
    if isinstance(out, dict):
        return {k: _as_tensors(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_as_tensors(o) for o in out]
    return torch.as_tensor(out)


def _host_profile(what, call, n=N_TIMED_REQUESTS, top=8):
    """cProfile's view of ``n`` calls ``call(i)``: the functions with the
    most time of their own, per call (the first wait for the device shows
    as the copy to the host that waits)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for i in range(n):
        call(i)
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])
    total = sum(v[2] for _, v in rows)
    print(f"host profile of {what} (cProfile, {n} calls): "
          f"{1e3 * total / n:.3f} ms a call under the profiler; own time "
          f"per call, largest first:")
    for (path, line, name), (_, calls, own, _, _) in rows[:top]:
        print(f"  {1e3 * own / n:8.4f} ms  x{calls // n:<3d} "
              f"{os.path.basename(path)}:{line} {name}"[:110])


def _infer_pair(ops, what, run, failures, want_launches):
    """``run(cuda_graph)`` graphed ("auto") and eager (False) from the
    same seeds, each with the forward's count from 0; prints and checks
    their max_abs_err (expected 0) and that each launched the forward
    ``want_launches`` times. Returns the graphed run's launches."""
    counted = []
    for cuda_graph in ("auto", False):
        ops.fused_mlp.launches = 0
        counted.append((run(cuda_graph), ops.fused_mlp.launches))
    (got, n_graph), (want, n_eager) = counted
    worst = _max_diff(_as_tensors(got), _as_tensors(want))
    print(f"graph vs eager inference, {what}: max_abs_err {worst:.3e} "
          f"(expected 0); fused_mlp_fwd launches {n_graph} graphed, "
          f"{n_eager} eager (expected {want_launches})")
    if worst != 0 or n_graph != want_launches or n_eager != want_launches:
        failures.append(f"graph vs eager inference ({what}): max_abs_err "
                        f"{worst:.3e}, launches {n_graph} and {n_eager}")
    return n_graph


def _graph_requests(ops, failures, card, setups, served):
    """Phase 17 (a): the Predictors of phases 4 and 7 and phase 11's
    artifact, graphed against eager: values, launches, two shapes in
    turns, per-request times and one profiled request of each. Returns
    the forward launches of the graphed kernel Predictors' requests."""
    from dpivae_tpu_torch.serving import SAMPLE_SLOTS, Predictor

    outputs = tuple(SAMPLE_SLOTS)
    launches = 0
    for name, (cfg, case, model, params, request) in setups.items():
        x, c = request
        models = {"kernel": model}
        if name == "simple_beam":
            models["plain"] = dataclasses.replace(model, use_pallas=False)
        for kind, m in models.items():
            def run(cuda_graph, m=m):
                p = Predictor(m, params, cfg, outputs=outputs,
                              device="cuda", cuda_graph=cuda_graph)
                return [p(x, c, seed=s) for s in range(N_REQUESTS)]

            launches += _infer_pair(
                ops, f"{name} Predictor ({kind}), {N_REQUESTS} requests of "
                f"{cfg.n_test} x {cfg.n_mc_test} MC, 8 outputs", run,
                failures, N_REQUESTS if m.use_pallas else 0)

    cfg, case, model, params, (x, c) = setups["simple_beam"]
    sizes = (cfg.n_test, 7, cfg.n_test, 7)

    def interleaved(cuda_graph):
        p = Predictor(model, params, cfg, outputs=outputs, device="cuda",
                      cuda_graph=cuda_graph)
        return [p(x[:b], c[:b], seed=i) for i, b in enumerate(sizes)]

    launches += _infer_pair(
        ops, f"simple_beam requests of {sizes} points in turns (two graphs "
        f"on one pool)", interleaved, failures, len(sizes))
    graphed = Predictor(model, params, cfg, outputs=outputs, device="cuda")
    eager = Predictor(model, params, cfg, outputs=outputs, device="cuda",
                      cuda_graph=False)
    times = _per_request_times({"graphed": graphed, "eager": eager}, x, c)
    med = {}
    for kind, t in times.items():
        q1, med[kind], q3 = statistics.quantiles(t, n=4)
        print(f"per request {cfg.n_test} x {cfg.n_mc_test} MC ({card}), "
              f"{kind} kernel Predictor: median {med[kind]:.3f} ms, "
              f"quartiles {q1:.3f}-{q3:.3f} ms over {N_TIMED_REQUESTS} "
              f"requests (alternating turns)")
    print(f"graphed request: {med['eager'] / med['graphed']:.2f}x the eager "
          f"one")
    _profile_request("one replayed request", graphed, (x, c),
                     med["graphed"])
    _host_profile("replayed requests", lambda i: graphed(x, c, seed=i))
    _profile_request("one eager request", eager, (x, c), med["eager"])

    from dpivae_tpu_torch.utils import graph_cache

    eager_served = dataclasses.replace(served, cuda_graph=False)

    def artifact(cuda_graph):
        p = served if cuda_graph == "auto" else eager_served
        return [p(x[:b], c[:b], seed=b) for b in (1, 7, cfg.n_test, 7)]

    _infer_pair(ops, f"artifact at 1, 7, {cfg.n_test} and 7 points x "
                f"{cfg.n_mc_test} MC, 8 outputs", artifact, failures, 0)
    times = _per_request_times({"graphed": served, "eager": eager_served},
                               x, c)
    for kind, t in times.items():
        q1, med[kind], q3 = statistics.quantiles(t, n=4)
        print(f"per request {cfg.n_test} x {cfg.n_mc_test} MC ({card}), "
              f"{kind} artifact: median {med[kind]:.3f} ms, quartiles "
              f"{q1:.3f}-{q3:.3f} ms over {N_TIMED_REQUESTS} requests "
              f"(alternating turns)")
    _profile_request("one replayed artifact request", served, (x, c),
                     med["graphed"])
    print(f"graph cache after phase 17's requests: {graph_cache.entries()} "
          f"graphs, {graph_cache.held_bytes() / 1e6:.1f} MB held (their "
          f"pool's segments and static inputs); "
          f"{torch.cuda.memory_reserved() / 1e6:.1f} MB reserved in all")
    return launches


def _graph_eval_figures(ops, failures, card, setup, run):
    """Phase 17 (b): ``evaluate_model`` and ``sample_latents`` graphed
    against eager, the caller's generator after them, and one prediction
    figure's data and ``marginal_prior_data`` at the config's 2,000 x 5.
    Returns the forward launches of the graphed prediction figure."""
    from dpivae_tpu_torch.eval import evaluate_model, sample_latents
    from dpivae_tpu_torch.utils.data import sample_response
    from dpivae_tpu_torch.viz import visualization as viz

    cfg, case, model, params, _ = setup
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    data = sample_response(case, gen, cfg.n_test, sample_dist=case.gt_dist(),
                           device="cuda")
    after = {}

    def evaluate(cuda_graph):
        g = torch.Generator(device="cuda").manual_seed(SEED + 4)
        out = [evaluate_model(cfg, case, model, params, data, generator=g,
                              cuda_graph=cuda_graph)[1][cfg.name],
               *sample_latents(cfg, model, params, data[0], data[1],
                               n=cfg.n_mc_test, generator=g,
                               cuda_graph=cuda_graph)]
        after[cuda_graph] = torch.randn(64, generator=g, device="cuda")
        return [torch.as_tensor(o) for o in out]

    _infer_pair(ops, f"evaluate_model's y and sample_latents' (zx, zc, zy) "
                f"at {cfg.n_test} points x {cfg.n_mc_test} MC", evaluate,
                failures, 0)
    same = torch.equal(after["auto"], after[False])
    print(f"the caller's generator after the graphed calls draws what it "
          f"draws after the eager ones: {same}")
    if not same:
        failures.append("graphed evaluate: the caller's generator differs")

    cfg, case, model, params = (run.config, run.case, run.model, run.params)
    figures = {
        "fig_pred_x_0": (cfg.n_interp, lambda cuda_graph: list(
            viz.pred_decomposition(
                model, params, cfg, case, 0, cfg.n_interp, cfg.n_plot, False,
                cfg.seed + 5, device="cuda",
                cuda_graph=cuda_graph)[0].values())),
        "marginal_prior_data 0": (0, lambda cuda_graph: list(
            viz.marginal_prior_data(
                model, params, cfg, case, 0, cfg.n_interp, cfg.n_plot,
                cfg.seed + 5, device="cuda", cuda_graph=cuda_graph)[0])),
    }
    launches = 0
    for name, (want, fn) in figures.items():
        launches += _infer_pair(ops, f"{name} data at n_plot {cfg.n_plot} x "
                                f"n_interp {cfg.n_interp}", fn, failures,
                                want)
        walls = {"auto": [], False: []}
        for turn in range(4):
            for cuda_graph in (("auto", False) if turn % 2 else
                               (False, "auto")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(cuda_graph)
                torch.cuda.synchronize()
                walls[cuda_graph].append(1e3 * (time.perf_counter() - t0))
        print(f"figure data {name} ({card}), median of 4 warm runs in "
              f"turns: graphed {statistics.median(walls['auto']):.1f} ms, "
              f"eager {statistics.median(walls[False]):.1f} ms")
    return launches


class _CacheCounts:
    """Counts, while it is entered, the captures and replays of the
    graphs of ``utils/graph_cache.py``."""

    def __enter__(self):
        from dpivae_tpu_torch.utils import graph_cache

        self.captures = self.replays = 0
        counts, self._mod = self, graph_cache
        self._saved = graphed = graph_cache.Graphed

        class Counted(graphed):
            def __init__(self, *args, **kwargs):
                counts.captures += 1
                super().__init__(*args, **kwargs)

            def replay(self):
                counts.replays += 1
                return super().replay()

        graph_cache.Graphed = Counted
        return self

    def __exit__(self, *exc):
        self._mod.Graphed = self._saved
        return False


def _sweep_sampling(ops, failures, card, what, setup, chunk_size):
    """Phase 17 (c) for one sweep, ``setup`` = (config, case, result,
    data_train, x, c): ``sweep_sample``, ``sweep_predict_y`` and
    ``sweep_disentanglement_latents`` graphed ("auto") against
    ``cuda_graph=False`` from the same seeds, in turns: graphed (its
    capture included), eager, graphed, eager, graphed. Every output equal
    to the first eager one (max_abs_err 0) and every member's generator
    (each member's and each member key's) drawing the same next numbers
    after every call; one capture, one replay a chunk after it; the
    forward's launches one a chunk both ways where decoder_x runs (the
    kernel model's ``sweep_sample``). Returns the forward launches of the
    graphed calls."""
    from dpivae_tpu_torch.sweep import sweep as sweep_mod

    cfg, case, res, dtr, x, c = setup
    pts = SWEEP_SAMPLE_POINTS
    calls = {
        f"sweep_sample, 9 slots at {pts} points x {SWEEP_SAMPLE_MC} MC":
            lambda cuda_graph: sweep_mod.sweep_sample(
                cfg, case, res, dtr, x[:, :pts], c[:, :pts],
                n=SWEEP_SAMPLE_MC, seed=SEED + 6, chunk_size=chunk_size,
                cuda_graph=cuda_graph),
        f"sweep_predict_y at {x.shape[1]} points x {cfg.n_mc_test} MC":
            lambda cuda_graph: (sweep_mod.sweep_predict_y(
                cfg, case, res, dtr, x, c, n=cfg.n_mc_test, seed=SEED + 7,
                chunk_size=chunk_size, cuda_graph=cuda_graph),),
        f"sweep_disentanglement_latents at {STUDY_PROBE_POINTS} + "
        f"{STUDY_PROBE_POINTS} probe points":
            lambda cuda_graph: tuple(sweep_mod.sweep_disentanglement_latents(
                cfg, case, res, STUDY_PROBE_POINTS, STUDY_PROBE_POINTS,
                seed=SEED + 8, chunk_size=chunk_size,
                cuda_graph=cuda_graph).values()),
    }
    size, n_padded = sweep_mod._member_chunks(res.n_members, chunk_size)
    n_chunks = n_padded // size
    kernel = sweep_mod.member_config(cfg).use_pallas is True
    made = []
    make = sweep_mod.member_generators

    def recorded(*args, **kwargs):
        gens = make(*args, **kwargs)
        made.extend(gens)
        return gens

    launches = 0
    sweep_mod.member_generators = recorded
    try:
        for name, call in calls.items():
            turns = ("auto", False, "auto", False, "auto")
            walls, outs, draws, counted = {"auto": [], False: []}, [], [], []
            with _CacheCounts() as counts:
                for cuda_graph in turns:
                    made.clear()
                    before = ops.fused_mlp.launches
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = call(cuda_graph)
                    torch.cuda.synchronize()
                    walls[cuda_graph].append(
                        1e3 * (time.perf_counter() - t0))
                    counted.append(ops.fused_mlp.launches - before)
                    outs.append(out)
                    draws.append([torch.randn(8, generator=g, device=g.device)
                                  for g in made])
            want = outs[1]
            worst = max(_max_diff(o, want) for o in outs)
            same = all(torch.equal(a, b) for d in draws
                       for a, b in zip(d, draws[1]))
            want_launches = n_chunks if kernel and "sample," in name else 0
            replays = len(turns[::2]) * n_chunks - 1
            print(f"sweep sampling graph vs eager, {what}, {name}: "
                  f"max_abs_err {worst:.3e} (expected 0); {res.n_members} "
                  f"members in {n_chunks} chunk(s) of {size} "
                  f"({n_padded - res.n_members} padded); graphs "
                  f"{counts.captures} capture, {counts.replays} replays "
                  f"(expected 1, {replays}); fused_mlp_fwd launches "
                  f"{counted[0]}, {counted[2]} graphed, {counted[1]} eager "
                  f"(expected {want_launches}); the members' "
                  f"{len(draws[1])} generators' next draws equal after "
                  f"both paths: {same}")
            print(f"sweep sampling walls, {what}, {name} ({card}): graphed "
                  f"with its capture {walls['auto'][0]:.1f} ms, graphed "
                  f"warm {statistics.median(walls['auto'][1:]):.1f} ms, "
                  f"eager {statistics.median(walls[False]):.1f} ms (turns "
                  f"graphed, eager, graphed, eager, graphed)")
            if (worst != 0 or not same or (counts.captures, counts.replays)
                    != (1, replays)
                    or set(counted) != {want_launches}):
                failures.append(f"sweep sampling graph vs eager ({what}, "
                                f"{name}): max_abs_err {worst:.3e}, draws "
                                f"equal {same}, captures and replays "
                                f"{counts.captures}, {counts.replays}, "
                                f"launches {counted}")
            launches += counted[0] + counted[2] + counted[4]
    finally:
        sweep_mod.member_generators = make
    return launches


def _graph_sweeps(ops, failures, card, sweeps, stage_walls):
    """Phase 17 (c): the sweeps' sampling graphs (``_sweep_sampling``) of
    phase 10's 66-member damped_oscillator sweep ("auto": plain), at the
    default chunk, and phase 12's 24-member bridge / "DPIVAE-A" grid
    (use_pallas=True) in chunks of at most 5 (5 chunks of 5: one pad),
    from an empty member cache; the bytes the member entries hold before
    and after an eviction by their bound; the walls of the study's latents
    stage and the transfer study's predict stages (phases 10 and 12, run
    through "auto"). Returns the forward launches of the graphed calls."""
    from dpivae_tpu_torch.sweep import sweep_predict_y
    from dpivae_tpu_torch.utils import graph_cache

    held = graph_cache._MEMBER_CACHE
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    print(f"sweep sampling graphs held after phases 10-16: {len(held)} "
          f"entries, {held.nbytes() / 1e6:.1f} MB (bound {held.share:.2f} "
          f"x {card_bytes / 1e9:.1f} GB); phase 17 (c) starts from an "
          f"empty member cache")
    graph_cache._MEMBER_CACHE = graph_cache.ByteLRU(held.share)
    del held
    torch.cuda.empty_cache()
    launches = 0
    for what, (setup, chunk_size) in sweeps.items():
        launches += _sweep_sampling(ops, failures, card, what, setup,
                                    chunk_size)
    cache = graph_cache._MEMBER_CACHE
    print("sweep sampling graphs, each entry's bytes (its own pool and "
          "static inputs), in the order above: " + ", ".join(
              f"{e.nbytes / 1e6:.1f} MB" for e in cache.entries()))
    before = (len(cache), cache.nbytes(), graph_cache.held_bytes(),
              torch.cuda.memory_reserved())
    # A bound of 0 keeps only the newest entry: one new signature (the
    # grid's ŷ at 64 MC) evicts every other.
    cache.share = 0.0
    (setup, chunk_size), = [v for k, v in sweeps.items() if "grid" in k]
    cfg, case, res, dtr, x, c = setup
    sweep_predict_y(cfg, case, res, dtr, x, c, n=64, seed=SEED,
                    chunk_size=chunk_size)
    after = (len(cache), cache.nbytes(), graph_cache.held_bytes(),
             torch.cuda.memory_reserved())
    cache.share = graph_cache._MEMBER_SHARE
    print(f"sweep sampling graphs ({card}): before an eviction "
          f"{before[0]} entries, {before[1] / 1e6:.1f} MB in their own "
          f"pools and static inputs ({before[2] / 1e6:.1f} MB held by all "
          f"the graph caches, {before[3] / 1e6:.1f} MB reserved in all); "
          f"after it (bound 0: the newest kept) {after[0]} entry, "
          f"{after[1] / 1e6:.1f} MB ({after[2] / 1e6:.1f} MB, "
          f"{after[3] / 1e6:.1f} MB reserved)")
    if after[0] != 1 or not after[3] < before[3]:
        failures.append(f"sweep sampling graphs: the eviction left "
                        f"{after[0]} entries, reserved {before[3]} -> "
                        f"{after[3]} bytes")
    print(f"stage walls through 'auto' ({card}): the study's latents "
          + ", ".join(f"{w:.3f} s" for w in stage_walls["latents"])
          + " (trained, resumed, resumed with mlp probes); the transfer "
          "study's predict " + ", ".join(
              f"{k} {w:.3f} s" for k, w in stage_walls["predict"]))
    return launches


def _graph_inference(ops, failures, card, setups, served, run, sweeps,
                     stage_walls):
    """Phase 17. Returns the forward launches of its graphed calls."""
    return (_graph_requests(ops, failures, card, setups, served)
            + _graph_eval_figures(ops, failures, card,
                                  setups["simple_beam"], run)
            + _graph_sweeps(ops, failures, card, sweeps, stage_walls))


def main() -> int:
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dpivae_tpu_torch.ops import fused_mlp as ops

    card = _card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    t0 = time.perf_counter()
    lib_path, log = ops.build_library()
    print(f"built {os.path.relpath(lib_path)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "Compiling entry" in line):
            print(f"  ptxas: {line.strip()}")

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = ops._library()
    print("staged forward, shared memory per block at d_in 4: " + ", ".join(
        f"H {h} {lib.fused_mlp_fwd_smem_bytes(4, h)} B" for h in (128, 512, 1024))
        + f" (limit {limit} B; above it the split path runs)")

    results = _kernel_vs_plain(ops.fused_mlp, ops.fused_mlp_reference,
                               failures)
    hidden = _hidden_vs_plain(ops, failures)
    backward = _backward_vs_plain(ops, failures)
    _paths_vs_plain(ops, failures)
    _against_f64(ops)
    _cnn_encoder_on_card(failures)

    # The main path of the first slices: simple_beam / "dpivae" (S model,
    # 4 -> 128 -> 32).
    (serve_launches, req_ms, req_plain_ms, predictor, request,
     serve_setup) = _serving(ops, failures, "simple_beam", "dpivae")
    print(f"per request ({card}): kernel model {req_ms:.3f} ms, "
          f"plain model {req_plain_ms:.3f} ms "
          f"(warm median of {N_TIMED_REQUESTS})")
    _profile_request("one request", predictor, request, req_ms)
    _profile_kernels(ops.fused_mlp, ops.fused_mlp_hidden)
    (fwd_launches, hidden_launches), steps_s, setup = _training(
        ops, failures, "simple_beam", "dpivae", N_ITER)
    print(f"training steps/s ({card}): kernel model {steps_s['kernel']:.1f}, "
          f"plain model {steps_s['plain']:.1f} (n_iter {N_ITER})")
    _profile_train_step(setup)

    # This slice's paths (8 -> 128 -> 64): bridge / "DPIVAE-A" (P model,
    # surrogate partial physics, a physical covariate) serving and
    # training, and damped_oscillator / "dpivae" (S model) serving.
    (b_launches, b_req_ms, b_plain_ms, b_predictor, b_request,
     b_setup) = _serving(ops, failures, "bridge", "DPIVAE-A")
    print(f"per request bridge / 'DPIVAE-A' ({card}): kernel model "
          f"{b_req_ms:.3f} ms, plain model {b_plain_ms:.3f} ms")
    _profile_request("one bridge / 'DPIVAE-A' request", b_predictor,
                     b_request, b_req_ms)
    (b_fwd, b_hidden), b_steps_s, _ = _training(
        ops, failures, "bridge", "DPIVAE-A", N_ITER_BRIDGE)
    print(f"training steps/s bridge / 'DPIVAE-A' ({card}): kernel model "
          f"{b_steps_s['kernel']:.1f}, plain model {b_steps_s['plain']:.1f} "
          f"(n_iter {N_ITER_BRIDGE})")
    o_launches, o_req_ms, o_plain_ms, _, o_request, o_setup = _serving(
        ops, failures, "damped_oscillator", "dpivae")
    print(f"per request damped_oscillator / 'dpivae' ({card}): kernel "
          f"model {o_req_ms:.3f} ms, plain model {o_plain_ms:.3f} ms")

    # This slice's paths: the single-run program, then the decode's two
    # options.
    (s_fwd, s_hidden), run = _single_run(ops, failures, card)
    d_fwd, d_hidden = _decode_options(ops, failures, card)

    # This slice's paths: sweeps and the study on them (damped_oscillator,
    # 8 -> 128 -> 64, 66 members).
    batched = _batched_kernels(ops, failures)
    (w_fwd, w_hidden), member_steps, sweep_setup = _sweep(ops, failures,
                                                          card)
    print(f"sweep member-steps/s ({card}): use_pallas 'auto' (plain) "
          f"{member_steps['auto']:.1f}, use_pallas=True (kernels) "
          f"{member_steps['kernel']:.1f} ({SWEEP_MEMBERS} members x "
          f"{N_ITER_SWEEP} steps)")
    (y_fwd, y_hidden), latents_walls = _study(ops, failures, card)

    # This slice's paths: the serving artifact, then the transfer study
    # (bridge, both presets, 24 members each) and its use_pallas=True grid.
    a_fwd, served = _artifact(ops, failures, card, serve_setup, request)
    ((t_fwd, t_hidden), transfer_steps, grid, grid_setup,
     predict_walls) = _transfer(ops, failures, card)
    print(f"transfer grid member-steps/s ({card}): use_pallas 'auto' "
          f"(plain) {transfer_steps['auto']:.1f}, use_pallas=True (kernels) "
          f"{transfer_steps['kernel']:.1f} ({TRANSFER_RUNS * 4} members x "
          f"{N_ITER_TRANSFER_KERNEL} steps)")

    # The figures' data on the card.
    f_fwd = _figures(ops, failures, card, run)

    # This slice's paths: the device mesh (one-rank NCCL group).
    m_fwd, m_hidden = _mesh(ops, failures, card)

    # This slice's paths: remat and bf16 in sweeps, a CNN-encoder model,
    # and the three example programs.
    e_fwd, e_hidden = _phase15(ops, failures, card, served, request)

    # The graphed training loop against the eager one.
    g_fwd, g_hidden = _graphs(ops, failures, card, setup, grid)

    # This slice's path: the graphed inference calls against eager ones.
    setups = {"simple_beam": (*serve_setup, request),
              "bridge": (*b_setup, b_request),
              "damped_oscillator": (*o_setup, o_request)}
    sweeps = {
        f"phase 10's {SWEEP_MEMBERS} damped_oscillator members ('auto': "
        f"plain)": (sweep_setup, None),
        f"phase 12's {TRANSFER_RUNS * 4}-member bridge / 'DPIVAE-A' grid "
        f"(use_pallas=True)": (grid_setup, GRID_SAMPLING_CHUNK)}
    i_fwd = _graph_inference(ops, failures, card, setups, served, run,
                             sweeps, {"latents": latents_walls,
                                      "predict": predict_walls})

    fwd_total = (serve_launches + fwd_launches + b_launches + b_fwd
                 + o_launches + s_fwd + d_fwd + w_fwd + y_fwd + a_fwd + t_fwd
                 + f_fwd + m_fwd + e_fwd + g_fwd + i_fwd)
    hidden_total = (hidden_launches + b_hidden + s_hidden + d_hidden
                    + w_hidden + y_hidden + t_hidden + m_hidden + e_hidden
                    + g_hidden)
    print(f"launches on the main paths: fused_mlp_fwd simple_beam serving "
          f"{serve_launches} + training {fwd_launches}, bridge serving "
          f"{b_launches} + training {b_fwd}, damped_oscillator serving "
          f"{o_launches}, single run {s_fwd}, remat and bf16 {d_fwd}, "
          f"sweep {w_fwd} (member-batched), study {y_fwd}, artifact phase "
          f"{a_fwd} (the live kernel Predictor), transfer {t_fwd} "
          f"(member-batched), figures {f_fwd}, mesh {m_fwd}, remat sweeps, "
          f"CNN model and examples {e_fwd}, graphed loop {g_fwd}, graphed "
          f"inference {i_fwd} = {fwd_total}; "
          f"fused_mlp_hidden simple_beam "
          f"training {hidden_launches} + bridge training {b_hidden} + single "
          f"run {s_hidden} + remat and bf16 {d_hidden} + sweep {w_hidden} + "
          f"study {y_hidden} + transfer {t_hidden} + mesh {m_hidden} + "
          f"remat sweeps, CNN model and examples {e_hidden} + graphed loop "
          f"{g_hidden} = {hidden_total}")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(f"chip_smoke wall ({card}): "
          f"{time.perf_counter() - script_t0:.1f} s (limit 1,200 s)")
    serving, train_hidden = results["serving"], hidden["training"]
    source = "dpivae_tpu_torch/csrc/fused_mlp.cu"
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": source,
        "replaces": "dpivae_tpu/ops/pallas_mlp.py:38",
        "launches": fwd_total,
        "max_abs_err": max([r["max_abs_err"] for r in results.values()]
                           + [batched["forward_training"]["max_abs_err"],
                              batched["forward_validation"]["max_abs_err"]]),
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }, {
        "name": "fused_mlp_hidden",
        "route": "cuda",
        "source": source,
        "replaces": "dpivae_tpu/ops/pallas_mlp.py:46",
        "launches": hidden_total,
        "max_abs_err": max([r["max_abs_err"] for r in hidden.values()]
                           + [backward["max_abs_err"],
                              batched["hidden_training"]["max_abs_err"],
                              batched["vmap_grad"]["max_abs_err"]]),
        "ms": train_hidden["ms"],
        "plain_ms": train_hidden["plain_ms"],
        "bound_ms": train_hidden["bound_ms"],
        "bound_by": train_hidden["bound_by"],
        "library_ms": train_hidden["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
