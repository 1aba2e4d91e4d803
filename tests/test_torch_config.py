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
