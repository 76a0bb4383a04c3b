"""Share of its roofline the fused-MLP kernels reach in replayed training
blocks (%): each block's least time by the frozen count
(``portbench/work/counts.py``: ``val_freq`` forwards and hidden
recomputes at the batch's rows and one validation forward), over the
device time of the fused-MLP kernels those blocks launched."""

from portbench import trace
from portbench.work import counts


def read(rec):
    ev = rec["slice"]
    launches = trace.graph_launches(ev)
    fused = [d for d in trace.launched_by(ev, launches) if "fused_mlp" in d[0]]
    if not fused:
        return None
    spent = sum(e - s for _, s, e, _ in fused) / 1e9
    least = len(launches) * counts.train_block_fused_least_s(rec["work"])
    return 100.0 * least / spent
