"""Device kernels per optimizer step of a replayed block: the kernels the
slice's ``cudaGraphLaunch`` calls started (by correlation id), over the
steps those blocks hold (a member-batched step counts once); the
validation's kernels are shared out over its block."""

from portbench import trace


def read(rec):
    ev = rec["slice"]
    launches = trace.graph_launches(ev)
    kernels = [d for d in trace.launched_by(ev, launches)
               if trace.is_kernel(d[0])]
    if not launches or not kernels:
        return None
    return len(kernels) / (len(launches) * rec["val_freq"])
