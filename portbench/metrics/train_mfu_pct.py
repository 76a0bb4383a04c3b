"""Model FLOP utilisation of training over the slice (%): the model's
FLOPs per step (``portbench/work/counts.py``) times the member-steps of
the blocks the slice launched, over the slice's length at the TF32
peak."""

from portbench import trace
from portbench.work import counts


def read(rec):
    ev = rec["slice"]
    steps = len(trace.graph_launches(ev)) * rec["val_freq"] * rec["members"]
    flops = steps * counts.train_step_flops(rec["work"])
    return 100.0 * flops / (trace.window_s(ev) * counts.TF32_FLOPS)
