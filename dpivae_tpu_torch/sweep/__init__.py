"""Member-batched sweeps (counterpart of dpivae_tpu/sweep/)."""

from dpivae_tpu_torch.sweep.sweep import (  # noqa: F401
    LATENTS_CHUNK_DEFAULT,
    HyperSweepResult,
    SweepResult,
    auto_chunk_size,
    clean_checkpoint_dir,
    export_member,
    export_member_predictor,
    member_datasets,
    member_model,
    sweep_disentanglement_latents,
    sweep_predict_y,
    sweep_sample,
    train_hyper_sweep,
    train_sweep,
    train_sweep_data,
)
