"""The device's idle share of the training slice (%): 100 minus the union
of the device operations' intervals over the slice."""

from portbench import trace


def read(rec):
    ev = rec["slice"]
    return 100.0 * (1.0 - trace.busy_s(ev) / trace.window_s(ev))
