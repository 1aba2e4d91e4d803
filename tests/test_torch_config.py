"""The port's config validation vs the JAX package's, on the CPU.

The same shipped YAML, with its optimizer name changed, goes through both
packages' ``load_config``: both must reject a name their ``get_optimizer``
does not build, and both must accept the ones it does.
"""

import pytest
import yaml

from speech_enhancement_tpu.config import load_config as jax_load_config
from speech_enhancement_torch.config import load_config

SHIPPED = "configs/dccrn_vbd.yaml"


def _with_optimizer(tmp_path, name):
    with open(SHIPPED) as handle:
        data = yaml.safe_load(handle)
    data.setdefault("optim", {})["optim"] = name
    path = tmp_path / f"dccrn_{name}.yaml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


@pytest.mark.parametrize("name", ["rmsprop", "Adam", ""])
def test_both_packages_reject_an_unknown_optimizer(tmp_path, name):
    path = _with_optimizer(tmp_path, name)
    with pytest.raises(ValueError, match=f"unknown optimizer {name!r}"):
        jax_load_config(path)
    with pytest.raises(ValueError, match=f"unknown optimizer {name!r}"):
        load_config(path)


@pytest.mark.parametrize("name", ["adam", "sgd", "adamw"])
def test_both_packages_accept_a_known_optimizer(tmp_path, name):
    path = _with_optimizer(tmp_path, name)
    assert jax_load_config(path).optim.optim == name
    assert load_config(path).optim.optim == name


def test_defaults_equal_the_jax_defaults_section_by_section():
    from speech_enhancement_torch import config as port_config
    from speech_enhancement_tpu import config as jax_config

    assert sorted(port_config._DEFAULTS) == sorted(jax_config._DEFAULTS)
    for section, value in jax_config._DEFAULTS.items():
        assert port_config._DEFAULTS[section] == value, section


@pytest.mark.parametrize("shipped", ["configs/dccrn_vbd.yaml", "configs/sepformer_clarity.yaml",
                                     "configs/crn_vbd.yaml"])
def test_save_yaml_round_trips_and_matches_jax(tmp_path, shipped):
    from speech_enhancement_torch.config import save_yaml
    from speech_enhancement_tpu.config import save_yaml as jax_save_yaml

    cfg = load_config(shipped)
    assert cfg.to_dict() == jax_load_config(shipped).to_dict()
    save_yaml(cfg, str(tmp_path / "port.yaml"))
    jax_save_yaml(jax_load_config(shipped), str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert load_config(str(tmp_path / "port.yaml")) == cfg


def test_merged_setitem_copy_and_json(tmp_path):
    import numpy as np

    from speech_enhancement_torch.config import Config, load_json, obj2dict, save_json
    from speech_enhancement_tpu.config import Config as JaxConfig

    base = {"solver": {"batch_size": 4, "test": {"metrics": ["sisdr"]}}, "seed": 1}
    extra = {"solver": {"test": {"total_steps": 6}}, "seed": 2}
    got, want = Config(base).merged(extra), JaxConfig(base).merged(extra)
    assert obj2dict(got) == want.to_dict() == {
        "solver": {"batch_size": 4, "test": {"metrics": ["sisdr"], "total_steps": 6}}, "seed": 2}
    copy = got.copy()
    copy.solver["batch_size"] = 8
    assert copy.setdefault("misc", {"show": True}).show and got.solver.batch_size == 4
    assert isinstance(copy.solver, Config) and copy.solver.batch_size == 8
    blob = {"best": np.float32(0.5), "steps": np.int64(3), "ok": np.bool_(True),
            "curve": np.arange(3)}
    save_json(blob, str(tmp_path / "state.json"))
    assert load_json(str(tmp_path / "state.json")) == {"best": 0.5, "steps": 3, "ok": True,
                                                       "curve": [0, 1, 2]}
