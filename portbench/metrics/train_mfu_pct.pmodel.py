"""Model FLOP utilisation of the P model's training over the slice (%):
the P model's FLOPs per member-step (``portbench/work/counts_p.py``)
times the member-steps of the blocks the slice launched, over the
slice's length at the TF32 peak."""

from portbench import trace
from portbench.work import counts, counts_p


def read(rec):
    ev = rec["slice"]
    steps = len(trace.graph_launches(ev)) * rec["val_freq"] * rec["members"]
    if not steps:
        return None
    flops = steps * counts_p.train_step_flops(rec["work"])
    return 100.0 * flops / (trace.window_s(ev) * counts.TF32_FLOPS)
