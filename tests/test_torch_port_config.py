"""dpivae_tpu_torch.config against dpivae_tpu.config: the same fields,
defaults, preset overlays, validation and JSON round trip."""

import dataclasses

import pytest

from dpivae_tpu.cases import get_case as jax_get_case, list_cases
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu_torch.config import AnnealingConfig, TrainConfig


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_match():
    assert _fields(TrainConfig) == _fields(JaxTrainConfig)


def test_annealing_config_matches():
    from dpivae_tpu.config import AnnealingConfig as JaxAnnealing

    assert _fields(AnnealingConfig) == _fields(JaxAnnealing)
    for which in ("lambda", "beta_x", "beta_c", "beta_y"):
        assert (dataclasses.asdict(TrainConfig().annealing(which))
                == dataclasses.asdict(JaxTrainConfig().annealing(which)))


@pytest.mark.parametrize("case_name", list_cases())
def test_preset_overlays_match(case_name):
    for preset in jax_get_case(case_name).presets.values():
        assert (dataclasses.asdict(TrainConfig().with_preset(preset))
                == dataclasses.asdict(JaxTrainConfig().with_preset(preset)))


@pytest.mark.parametrize("kwargs", [
    dict(use_pallas="false"),
    dict(compute_dtype="float16"),
    dict(mc_chunk=True),
    dict(mc_chunk=0),
    dict(mc_chunk=3),
    dict(compute_dtype="bfloat16", use_pallas=True),
])
def test_validation_matches(kwargs):
    with pytest.raises(ValueError):
        JaxTrainConfig(**kwargs)
    with pytest.raises(ValueError):
        TrainConfig(**kwargs)


def test_unknown_preset_key_raises():
    with pytest.raises(ValueError, match="Unknown preset keys"):
        TrainConfig().with_preset({"not_a_field": 1})


def test_json_round_trip(tmp_path):
    cfg = TrainConfig().replace(use_pallas=True, n_mc_test=8, name="rt")
    path = str(tmp_path / "cfg.json")
    cfg.save_json(path)
    assert TrainConfig.from_json(path) == cfg
    assert JaxTrainConfig.from_json(path) == JaxTrainConfig().replace(
        use_pallas=True, n_mc_test=8, name="rt"
    )
