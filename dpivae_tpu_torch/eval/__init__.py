"""Evaluation: the VAE's test metrics, the comparison baselines and the
disentanglement metric (counterpart of dpivae_tpu/eval/)."""

from dpivae_tpu_torch.eval.baselines import (  # noqa: F401
    fit_gpr_batched,
    fit_gpr_lbfgsb,
    fit_lin_batched,
    fit_mlp_baseline_batched,
    run_comparison_batched,
)
from dpivae_tpu_torch.eval.evaluate import (  # noqa: F401
    build_eval_sample_fn,
    disentanglement_metric,
    evaluate_model,
    fit_disentanglement_probes,
    run_comparison,
    sample_latents,
)
from dpivae_tpu_torch.eval.probes import (  # noqa: F401
    batched_probe_scores,
    fit_linear_probes_batched,
    fit_mlp_probes_batched,
    make_probe_regressor,
    pack_probe_batch,
)
