"""YAML -> attribute-style config tree (counterpart of speech_enhancement_tpu/config.py).

Reads the repository's ``configs/*.yaml`` unchanged. Only what the ported
slice consumes is here: the ``Config`` bag, the YAML loader, the framework
defaults and their validation.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Optional

import yaml


class Config:
    """Recursive attribute bag over a dict, with dict round-trip.

    Nested mappings become nested attribute access; a missing attribute
    raises ``AttributeError`` (use :meth:`get` for optional fields).
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for key, value in data.items():
                self._data[str(key)] = _wrap(value)

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"config has no field {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {key: _unwrap(value) for key, value in self._data.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value.to_dict()
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def _deep_update(base: Dict[str, Any], extra: Dict[str, Any]) -> None:
    for key, value in extra.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_update(base[key], value)
        else:
            base[key] = copy.deepcopy(value)


def load_yaml(path: str) -> Config:
    """Load a YAML config file into a :class:`Config` tree."""
    with open(path, "r") as handle:
        data = yaml.safe_load(handle)
    return Config(data or {})


# The defaults of the sections the ported slice reads (same values as the
# JAX package's config._DEFAULTS for these sections).
_DEFAULTS: Dict[str, Any] = {
    "seed": 10,
    "optim": {
        "load": False,
        "optim": "adam",
        "lr": 3e-4,
        "beta1": 0.9,
        "beta2": 0.999,
        "momentum": 0.9,
        "loss": "mse",
        "clip_grad": 5.0,
        "pit": False,
        "pit_discard_compat": False,
    },
    "model": {
        "name": "dnn",
        "audio_channels": 1,
        "num_spk": 1,
        "segment": 4,
        "sample_rate": 16000,
        "n_fft": 512,
        "hop_length": 128,
        "win_length": 512,
        "center": True,
    },
    "dset": {
        "name": "VoiceBankDEMAND",
        "wav": "",
        "split": [0.85, 0.14, 0.01],
        "segment": 4,
        "audio_channels": 1,
        "sample_rate": 16000,
        "norm": "z-score",
        "mode": "se",
        "use_all": False,
    },
}


def with_defaults(config: Config) -> Config:
    """Return ``config`` deep-merged over the defaults, validated."""
    base = copy.deepcopy(_DEFAULTS)
    _deep_update(base, config.to_dict())
    merged = Config(base)
    validate(merged)
    return merged


def load_config(path: str) -> Config:
    return with_defaults(load_yaml(path))


def validate(config: Config) -> None:
    model = config.model
    if model.hop_length <= 0 or model.n_fft <= 0:
        raise ValueError("model.n_fft and model.hop_length must be positive")
    if model.win_length > model.n_fft:
        raise ValueError("model.win_length must be <= model.n_fft")
    if config.optim.optim not in ("adam", "sgd", "adamw"):
        raise ValueError(f"unknown optimizer {config.optim.optim!r}")
    if config.dset.norm not in ("z-score", "linear-scale", None, "", "none"):
        raise ValueError(f"unknown normalization {config.dset.norm!r}")
