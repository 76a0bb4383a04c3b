"""The control, on the card: the reference in TF32 put in the program's
place must come out not correct in every cell, at the cell's own size and
on three seeds (``python -m pytest portbench/tests -m cuda``)."""

import pytest
import torch

from portbench import common

BENCH = common.load_benchmark()
SEEDS = (2 ** 31 + 101, 2 ** 32 + 7, 2 ** 33 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_every_cell(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: TF32 exists only there")
    _, cfg, mix, limits = common.cell(BENCH, cell)
    drv = common.driver(mix["kind"])
    for seed in SEEDS:
        readings = drv.control(cfg, mix, seed, torch.device("cuda"))
        assert any(r[name] > limit for r in readings
                   for name, limit in limits.items()), (seed, readings)
