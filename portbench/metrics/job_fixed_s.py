"""A training job's fixed cost (s): from the job's start to its first
``CUDAGraph.replay`` call (the harness's span and ``trace.ReplayWatch``),
which is what each ``train_model`` / ``train_sweep`` call pays before
its replays: its set-up, its eager first block and its capture
(``_run_blocks``)."""


def read(rec):
    return rec.get("job_fixed_s")
