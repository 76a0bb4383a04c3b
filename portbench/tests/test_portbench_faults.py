"""The comparison that decides ``correct``, driven through a whole run on
the CPU (the look for a card skipped), small: sound, it passes; with the
timed path broken underneath, ``correct`` comes out false, once for each
fault a cell can have.

- a step that returns its state unchanged (the optimizer's update a
  no-op);
- half of the batch left out, the mean taken over the rest (the loss's
  per-datum rows of the first half, twice);
- one group's update skipped (decoder_y trained at a learning rate of 0);
- an answer altered where it is produced (a step's logged loss moved by
  a thousandth).

A cell of one card has no exchange between cards to leave out.
"""

import time

import pytest
import torch

from portbench import common, run

BENCH = common.load_benchmark()
SMALL = {
    "beam_train": dict(n_iter=20),
    "osc_sweep66": dict(n_iter=20, members=4),
}
TRAINING = ("beam_train", "osc_sweep66")


def _run(cell, seed=2 ** 31 + 977):
    rec, _, checks, _ = run.execute(BENCH, cell, seed, 0.5, False,
                                    torch.device("cpu"), time.perf_counter,
                                    SMALL[cell])
    return run.verdict(rec, checks), checks


@pytest.mark.parametrize("cell", TRAINING)
def test_sound_run_is_correct(cell):
    ok, checks = _run(cell)
    assert ok, checks


def _unchanged_state(monkeypatch):
    from dpivae_tpu_torch.train.optim import MemberAdam

    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
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
    made = common.train_config

    def without_decoder_y(cfg, **overrides):
        tc, case = made(cfg, **overrides)
        return tc.replace(lr_dy=0.0), case

    monkeypatch.setattr(common, "train_config", without_decoder_y)


def _altered_loss(monkeypatch):
    from dpivae_tpu_torch.train import train

    for cls in (train.Trainer, train.MemberTrainer):
        body = cls.step_body

        def altered(self, *args, _body=body, **kwargs):
            row = _body(self, *args, **kwargs)
            return row * (1.0 + 1e-3)

        monkeypatch.setattr(cls, "step_body", altered)


@pytest.mark.parametrize("cell", TRAINING)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _skipped_group, _altered_loss])
def test_training_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = _run(cell)
    assert not ok, checks
