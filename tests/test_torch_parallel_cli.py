"""The programs' --n_devices on the CPU: ``single_run`` over 2 gloo ranks
under ``torch.distributed.run`` against its run without a mesh, the study
with a one-rank "sweep" mesh in process against its run without the
flag, the refusal of --n_devices above 1 without the launcher, and the
multichip example over 2 spawned gloo ranks.

The 2-rank single run's metric CSVs are held to tests/test_parallel.py's
data-parallel bounds (rtol 2e-4 / atol 1e-5); the one-rank study must
write the same scores, byte for byte.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from dpivae_tpu_torch.scripts import (
    disentanglement_metric,
    regression_comparison,
    single_run,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n_iter", "20", "--n_train", "32", "--n_val", "16", "--n_test",
         "16", "--device", "cpu"]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in this process, as in the subprocesses: the
    sizes are small, and the suite runs beside other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_single_run_two_ranks_under_launcher(tmp_path):
    """Every rank trains, rank 0 alone writes; its metrics equal the run
    without a mesh (in a process of its own, at the same time) to the
    data-parallel bounds."""
    launched = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", "2", "-m",
                single_run.MODULE, "--n_devices", "2", *SMALL, "--output",
                str(tmp_path / "dp")]
    alone = [sys.executable, "-m", single_run.MODULE, *SMALL, "--output",
             str(tmp_path / "one")]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in (launched, alone)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:] + err[-3000:]
    assert outs[0][0].count("Training simple_beam/dpivae") == 1
    for name in ("train.csv", "val.csv"):
        head, got = _rows(tmp_path / "dp" / "single_run" / "metrics" / name)
        want_head, want = _rows(tmp_path / "one" / "single_run" / "metrics"
                                / name)
        assert head == want_head
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                   err_msg=name)
    dp_files = sorted(os.listdir(tmp_path / "dp" / "single_run" / "models"))
    assert dp_files == sorted(os.listdir(tmp_path / "one" / "single_run"
                                         / "models"))


def test_study_one_rank_mesh_equals_unsharded(tmp_path):
    """--n_devices 1 builds a one-rank "sweep" mesh in this process (no
    chunk files, the members' CSVs after training) and writes the scores
    of the run without the flag."""
    argv = ["--lambdas", "1e-4", "0", "--n_runs", "1", "--n_iter", "20",
            "--n_train_regressor", "64", "--n_test_regressor", "64",
            "--device", "cpu"]
    plain = disentanglement_metric.main([*argv, "--output",
                                         str(tmp_path / "a")])
    meshed = disentanglement_metric.main([*argv, "--output",
                                          str(tmp_path / "b"),
                                          "--n_devices", "1"])
    assert meshed.rows == plain.rows
    for study in (plain, meshed):
        with open(os.path.join(study.path, "disentanglement_score.csv")) as f:
            assert f.read().count("\n") == 1 + len(plain.rows)
    assert "chunks" not in os.listdir(meshed.path)
    for m in range(2):
        for name in ("train.csv", "val.csv"):
            with open(os.path.join(plain.path, str(m), "metrics", name)) as f:
                want = f.read()
            with open(os.path.join(meshed.path, str(m), "metrics", name)) as f:
                assert f.read() == want


@pytest.mark.parametrize("program", [single_run, disentanglement_metric,
                                     regression_comparison],
                         ids=lambda p: p.__name__.rsplit(".", 1)[1])
def test_n_devices_above_one_needs_the_launcher(program, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        program.main(["--n_devices", "2", "--output", str(tmp_path)])
    err = capsys.readouterr().err
    assert ("torch.distributed.run --standalone --nproc_per_node 2 -m "
            + program.MODULE) in err
    assert not os.listdir(tmp_path)


def test_multichip_example_spawns_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "dpivae_tpu_torch.examples.multichip_sweep",
         "--n_devices", "2", "--n_iter", "20", "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "multichip_sweep OK" in proc.stdout
