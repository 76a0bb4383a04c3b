"""The bridge case at its preset "DPIVAE-A" (the P model, the partial
physics as a frozen MLP over z_x and the physical covariate, λ = -1)
against the benchmark's plain reference, ``portbench/reference/
dpivae_p.py``, which imports nothing of the port: the loss and every
leaf's gradient on seeded weights and injected noise, and a data sweep of
two members of different domains through ``train_sweep_data`` against
the reference following each member's steps from its generator. Small
sizes (32 training points, batch 8, 4 MC samples), one intra-op thread.

Tolerances, both sides float32 on the CPU: the loss components 1e-6
relative (the two compose the same operations in the same order), each
leaf's gradient 1e-5 of its norm, sigma_x after each step 1e-6 relative,
the parameters after 3 Adam steps 1e-6 absolute (Adam moves each element
by about its learning rate, 1e-3, a step), leaving out the elements
whose first gradient is under 1e-3 of the median leaf's root mean
square: Adam moves those by the sign of a gradient that is nought to
rounding.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dpivae_tpu_torch.cases import get_case  # noqa: E402
from dpivae_tpu_torch.config import TrainConfig  # noqa: E402
from dpivae_tpu_torch.sweep import train_sweep_data  # noqa: E402
from dpivae_tpu_torch.train import setup_model  # noqa: E402
from portbench.reference import dpivae as ref  # noqa: E402
from portbench.reference import dpivae_p as ref_p  # noqa: E402

CASE = get_case("bridge")
SMALL = dict(n_train=32, n_val=16, n_batch=8, n_mc_train=4, n_mc_val=4)
CFG = dict(json.loads((ROOT / "portbench" / "configs" /
                       "bridge_p_dpivae_a.json").read_text()), **SMALL)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**over):
    return TrainConfig().with_preset(CASE.presets["DPIVAE-A"]).replace(
        **SMALL, **over)


def _data(seed, domain, n):
    g = torch.Generator().manual_seed(seed)
    return ref_p.domain_response(CFG, ref_p.load_arrays(CFG, "cpu"), g, n,
                                 domain)


def test_p_loss_and_grads_match_the_reference():
    cfg = _config()
    data = _data(5, 1, cfg.n_train)
    model = setup_model(cfg, CASE, data, device="cpu")
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    weights = ref_p.seeded_init(CFG, torch.Generator().manual_seed(7))
    names = [k for k, _ in params.named_parameters()]
    assert sorted(names) == sorted(weights)
    for k, v in params.state_dict().items():
        assert torch.equal(v, weights[k]), k
    n, b = 3, cfg.n_batch
    eps = torch.randn((n, b, 10), generator=torch.Generator().manual_seed(9))
    x, c, y = (a[:b] for a in data)
    out = model.loss(params, x, c, y, n=n, grl_alpha=-1.0, noise={"z": eps})
    div = torch.tensor([b * (CASE.nd_x + CASE.nd_c + CASE.nd_y)] + [b] * 7,
                       dtype=torch.float32)
    got = torch.sum(torch.stack(out), 1) / div
    grads = torch.autograd.grad(got[0], list(params.parameters()))
    reference = ref_p.Reference(CFG, data, torch.device("cpu"),
                                ref_p.load_arrays(CFG, "cpu", "part_"))
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = reference.loss_comps(p, x, c, y, eps, -1.0)
    want_grads = torch.autograd.grad(want[0], [p[k] for k in names])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for k, g, w in zip(names, grads, want_grads):
        assert float((g - w).norm()) <= 1e-5 * float(w.norm()), k


def test_data_sweep_follows_the_reference():
    cfg = _config(n_iter=3, use_seed=True, patience=10 ** 9)
    domains = (0, 3)
    sets = [tuple(_data(11 + d, d, n) for n in (cfg.n_train, cfg.n_val))
            for d in domains]
    stack = lambda i: tuple(torch.stack([s[i][k] for s in sets])
                            for k in range(3))
    seed = 2 ** 33 + 5
    res = train_sweep_data(cfg, CASE, np.full(2, cfg.lambda_g0, np.float32),
                           stack(0), stack(1), seed=seed, chunk_size=None,
                           device="cpu")
    part = ref_p.load_arrays(CFG, "cpu", "part_")
    for m, (data_train, data_val) in enumerate(sets):
        g = torch.Generator().manual_seed(ref.member_seed(seed, m))
        weights = ref_p.seeded_init(CFG, g)
        followed = ref_p.follow(CFG, part, weights, data_train, data_val, g,
                                -1.0, 3)
        torch.testing.assert_close(res.logs.train[m, :3, 12],
                                   followed.train[:, -1], rtol=1e-6,
                                   atol=0.0)
        floor = 1e-3 * float(np.median([
            float(v.norm()) / v.numel() ** 0.5
            for v in followed.grad0_full.values()]))
        for k, want in followed.params.items():
            live = followed.grad0_full[k].abs() >= floor
            got = res.params[k][m]
            assert float(((got - want) * live).abs().max()) <= 1e-6, k
