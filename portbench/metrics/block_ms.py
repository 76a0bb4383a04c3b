"""Time per replayed training block (ms): all the time between a job's
first and last ``cudaGraphLaunch`` in the slice, over the launches
between them (``train/graph.py`` ``Graphed.replay``)."""

from portbench import trace


def read(rec):
    launches = trace.graph_launches(rec["slice"])
    if len(launches) < 2:
        return None
    return (launches[-1][1] - launches[0][1]) / (len(launches) - 1) / 1e6
