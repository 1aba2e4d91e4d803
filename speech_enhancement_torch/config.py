"""YAML -> attribute-style config tree (counterpart of speech_enhancement_tpu/config.py).

Reads the repository's ``configs/*.yaml`` unchanged: the ``Config`` bag
with dict round trip, the YAML and JSON helpers the run dir uses
(``config.yaml``, ``state.json``, ``test_summary.json``), the framework
defaults of every section (the same values as the JAX package's) and their
validation.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterator, Optional

import numpy as np
import yaml


class Config:
    """Recursive attribute bag over a dict, with dict round-trip.

    Behaves like the reference's ``Config`` objects (src/utils.py:135-165):
    nested YAML mappings become nested attribute access; missing attributes
    raise ``AttributeError`` (use :meth:`get` for optional fields).
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for key, value in data.items():
                self._data[str(key)] = _wrap(value)

    # -- mapping-ish interface -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"config has no field {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        return NotImplemented

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def setdefault(self, name: str, default: Any = None) -> Any:
        if name not in self._data:
            self._data[name] = _wrap(default)
        return self._data[name]

    def to_dict(self) -> Dict[str, Any]:
        """Inverse of construction (reference: ``obj2dict`` utils.py:194-209)."""
        out: Dict[str, Any] = {}
        for key, value in self._data.items():
            out[key] = _unwrap(value)
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def merged(self, other: Optional[Dict[str, Any]]) -> "Config":
        """Deep-merge ``other`` on top of this config (new object)."""
        base = self.to_dict()
        _deep_update(base, other or {})
        return Config(base)


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


def dict2obj(data: Dict[str, Any]) -> Config:
    return Config(data)


def obj2dict(config: Config) -> Dict[str, Any]:
    return config.to_dict()


def load_yaml(path: str) -> Config:
    """Load a YAML config file into a :class:`Config` tree."""
    with open(path, "r") as handle:
        data = yaml.safe_load(handle)
    return Config(data or {})


def save_yaml(config: Config, path: str) -> None:
    with open(path, "w") as handle:
        yaml.safe_dump(config.to_dict(), handle, sort_keys=False)


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder tolerant of numpy scalars/arrays (reference: utils.py:211-239)."""

    def default(self, obj):  # noqa: D102
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def load_json(path: str) -> Any:
    with open(path, "r") as handle:
        return json.load(handle)


def save_json(data: Any, path: str) -> None:
    with open(path, "w") as handle:
        json.dump(data, handle, cls=NumpyEncoder, indent=2)


# ---------------------------------------------------------------------------
# Defaults + validation for the sections the engine consumes.
# ---------------------------------------------------------------------------

_DEFAULTS: Dict[str, Any] = {
    "seed": 10,
    "misc": {"num_workers": 1, "num_prints": 4, "show": False, "verbose": False},
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
        # rebuild-only knob: the reference computes utterance-PIT and then
        # discards it (src/solver.py:469-480); set True to replicate.
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
    "solver": {
        "root": ".",
        "num_workers": 0,
        "epochs": 1,
        "batch_size": 4,
        "all_steps": False,
        "total_steps": 8,
        "save_checkpoint_interval": 1,
        "patience": 40,
        "resume": "",
        # weights-only preload: a port .ckpt, or a reference torch
        # .pth/.pt/.tar (its keys are the port's, so it loads as it is)
        "preloaded_model": "",
        "validation": {"total_steps": 4, "interval": 1, "metric": "loss"},
        "test": {"total_steps": 4, "interval": 10, "num_show": 2, "metric": "sisdr"},
    },
    # Data parallelism (parallel/mesh.py), with the JAX package's fields.
    # A process holds one card: ``data * model`` is the world size of the
    # torch.distributed group, which main() joins when it is > 1 or
    # ``multihost`` is set, from ``coordinator_address`` (tcp://, with
    # ``num_processes`` / ``process_id`` as torch's world size and rank) or
    # from torchrun's environment (env://). ``solver.batch_size`` is the
    # PER-HOST batch, as in JAX: the ranks of a host split it along dim 0,
    # each host reads a disjoint shard of the train files
    # (data.loader.shard_for_process), and the global batch a step consumes
    # is batch_size times the number of hosts.
    "parallel": {"data": 1, "model": 1, "multihost": False,
                 "coordinator_address": "", "num_processes": 0,
                 "process_id": -1},
}


def with_defaults(config: Config) -> Config:
    """Return ``config`` deep-merged over the framework defaults."""
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
