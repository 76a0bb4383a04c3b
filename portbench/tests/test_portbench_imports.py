"""What a run may load: the reference nothing of the port, the harness
nothing of JAX; and a run without a card prints no result."""

import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.conftest import ROOT


def _loaded_after(module):
    code = (f"import sys; import {module}; print(sorted({{m.split('.')[0] "
            f"for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(eval(out.stdout))


def test_reference_imports_nothing_of_the_port_or_jax():
    tops = _loaded_after("portbench.reference.dpivae")
    assert not tops & {"dpivae_tpu_torch", "dpivae_tpu", "jax", "jaxlib",
                       "flax"}


def test_harness_imports_no_jax():
    tops = _loaded_after("portbench.run, portbench.drivers.train_jobs, "
                         "portbench.drivers.sweep_jobs")
    assert not tops & {"dpivae_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jaxtyping", "dpivae_tpu_torch.serving", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in run.forbidden_modules()
                if m in ("jaxtyping", "dpivae_tpu_torch.serving", "flaxen")]
    monkeypatch.setitem(sys.modules, "dpivae_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    found = run.forbidden_modules()
    assert "dpivae_tpu.models" in found and "jax.numpy" in found


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "beam_train",
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no result" in out.stderr
