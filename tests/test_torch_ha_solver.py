"""The Solver's Clarity hearing-aid columns through the port's ``main()`` on
the CPU (counterpart of tests/test_train_clarity.py's HA tests).

A small Sepformer on synthetic Clarity scenes with ``ha:`` set: ``--mode
test`` resumed from a one-epoch run writes finite ``haspi_*`` / ``hasqi_*``
columns in [0, 1] (the port's copy of the from-paper ear model, as the
``clarity`` package is absent here) and folds them into the summary; a
scorer whose metrics are ``None`` writes ``"gated"``; a missing listeners
file raises at init.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.synthetic import make_clarity, make_ha_config
from speech_enhancement_torch.ha.scoring import ClarityScorer
from speech_enhancement_torch.main import main
from test_torch_solver_models import SMALL_SEP

COLUMNS = ("haspi_enhance", "hasqi_enhance", "haspi_mixture", "hasqi_mixture")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clarity_root(tmp_path_factory):
    return make_clarity(str(tmp_path_factory.mktemp("clarity")), n_scenes=6, seconds=0.5,
                        seed=2)


def _config(data_root, run_root, ha_yaml):
    return with_defaults(Config({
        "optim": {"loss": "si-sdr", "lr": 1.5e-4, "pit": True}, "model": SMALL_SEP,
        "solver": {"root": run_root, "epochs": 1, "batch_size": 2, "all_steps": False,
                   "total_steps": 1, "validation": {"total_steps": 1},
                   "test": {"total_steps": 1, "num_show": 0, "metrics": ["sisdr"]}},
        "dset": {"name": "Clarity", "wav": data_root, "split": [0.5, 0.17, 0.33],
                 "segment": 0.25, "audio_channels": 2, "mode": "deverb"},
        "ha": ha_yaml}))


def _rows(run_dir):
    with open(os.path.join(run_dir, "results.csv")) as handle:
        return list(csv.DictReader(handle))


def test_mode_test_writes_ha_columns(clarity_root, tmp_path):
    """A 44.1 kHz chain from 16 kHz scenes (the resample runs), two listeners."""
    scenes = [f"S{i:05d}" for i in range(1, 7)]
    ha_yaml = make_ha_config(str(tmp_path / "ha"), scenes=scenes, n_listeners=2, fs=44100)
    cfg = _config(clarity_root, str(tmp_path / "root"), ha_yaml)
    trained = main(cfg, mode="train", return_solver=True, device="cpu",
                   run_dir=str(tmp_path / "train"))
    assert trained.clarity_scorer is not None and trained.clarity_scorer.device.type == "cpu"
    assert len(trained.clarity_scorer.listeners) == 2
    cfg.solver.resume = trained.run_dir
    tester = main(cfg, mode="test", return_solver=True, device="cpu",
                  run_dir=str(tmp_path / "test"))
    rows = _rows(tester.run_dir)
    assert len(rows) == 1
    for col in COLUMNS:
        value = float(rows[0][col])
        assert np.isfinite(value) and 0.0 <= value <= 1.0, col
    with open(os.path.join(tester.run_dir, "test_summary.json")) as handle:
        summary = json.load(handle)
    for side, key in (("enhanced", "haspi"), ("enhanced", "hasqi"), ("mixture", "haspi"),
                      ("mixture", "hasqi")):
        assert 0.0 <= summary[side][key] <= 1.0
    timing = tester.test_timing
    assert timing["ha_amplify_s"] > 0 and timing["ha_ear_model_s"] > 0


def test_gated_scores_and_missing_listeners(clarity_root, tmp_path, monkeypatch):
    """Metrics of ``None`` (a scoring backend that gates) write "gated", and
    stay out of the summary; a missing listeners file raises at init."""
    ha_yaml = make_ha_config(str(tmp_path / "ha"), scenes=["S00001"], n_listeners=1,
                             fs=16000)
    monkeypatch.setattr(ClarityScorer, "_haspi_hasqi", staticmethod(lambda *a: (None, None)))
    solver = main(_config(clarity_root, str(tmp_path / "root"), ha_yaml), mode=None,
                  return_solver=True, device="cpu", run_dir=str(tmp_path / "gated"))
    summary = solver.inference()
    assert [rows[col] for rows in _rows(solver.run_dir) for col in COLUMNS] == ["gated"] * 4
    assert "haspi" not in summary["enhanced"]

    missing = tmp_path / "missing.yaml"
    missing.write_text("path:\n  listeners_file: ./data/Clarity/metadata/listeners.json\n")
    with pytest.raises(FileNotFoundError, match="listeners.json"):
        main(_config(clarity_root, str(tmp_path / "root"), str(missing)), mode=None,
             device="cpu", run_dir=str(tmp_path / "missing"))
