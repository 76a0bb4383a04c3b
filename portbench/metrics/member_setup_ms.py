"""A data sweep's member set-up a job (ms): the port's spans
``sweep.member_data`` (the given datasets copied to host arrays) and
``sweep.member_starts`` (each member's generator, data and initial
weights, stacked on the device) summed over a ``train_sweep_data`` job,
the median over the window's jobs after the first (its first job carries
the traced slice), from the recording a traced run keeps in
``rec["program"]``; nothing where the program records no
``sweep.member_data``."""

import statistics


def read(rec):
    spans = rec.get("program", {}).get("spans", [])
    jobs = [s[0] for s in spans if s[3] == "job"
            and s[6].get("entry") == "train_sweep_data"]
    per_job = {j: 0 for j in jobs}
    seen = set()
    for _, _, job, name, t0, t1, _ in spans:
        if job in per_job and name in ("sweep.member_data",
                                       "sweep.member_starts"):
            per_job[job] += t1 - t0
            seen.add((job, name))
    later = [per_job[j] / 1e6 for j in jobs[1:]
             if (j, "sweep.member_data") in seen]
    return statistics.median(later) if later else None
