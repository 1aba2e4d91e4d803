"""CRN, MelRNN and Sepformer through the port's ``main()`` on the CPU, shrunk: one
epoch of two steps, a finite loss, the run dir's artifacts, and a test pass
(Sepformer: Clarity scenes, two speakers, si-sdr with PIT, the target
speaker's estimate scored)."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.synthetic import make_clarity, make_voicebank_demand
from speech_enhancement_torch.main import main

SMALL_CRN = {"name": "crn", "n_fft": 128, "hop_length": 32, "win_length": 128, "center": True,
             "segment": 0.25, "dtype": "float32", "fused_rnn": True}
SMALL_MEL = {"name": "mel-rnn", "n_fft": 128, "hop_length": 32, "win_length": 128,
             "center": True, "segment": 0.25, "rnn_type": "lstm", "rnn_hidden": 32,
             "rnn_layer": 2, "n_mels": 0, "fused_rnn": True}
SMALL_SEP = {"name": "sepformer", "audio_channels": 2, "num_spk": 2,
             "encoder_in_nchannels": 2, "encoder_out_nchannels": 32, "masknet_chunksize": 50,
             "masknet_numlayers": 1, "intra_numlayers": 1, "inter_numlayers": 1,
             "intra_nhead": 4, "inter_nhead": 4, "intra_dffn": 64, "inter_dffn": 64,
             "dtype": "float32", "fused_attention": True, "segment": 0.125,
             "win_length": 512}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models on the CPU run on one intra-op thread: as fast alone,
    and not slowed by the other test processes that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(name, data_root, run_root):
    solver = {"root": run_root, "epochs": 1, "batch_size": 2, "all_steps": False,
              "total_steps": 2, "validation": {"total_steps": 1},
              "test": {"total_steps": 2, "num_show": 0, "metrics": ["sisdr", "stoi"]}}
    if name in ("crn", "mel-rnn"):
        return with_defaults(Config({
            "optim": {"loss": "mse", "lr": 3e-4},
            "model": SMALL_CRN if name == "crn" else SMALL_MEL, "solver": solver,
            "dset": {"name": "VoiceBankDEMAND", "wav": data_root, "split": [0.5, 0.2, 0.3],
                     "segment": 0.5}}))
    return with_defaults(Config({
        "optim": {"loss": "si-sdr", "lr": 1.5e-4, "pit": True}, "model": SMALL_SEP,
        "solver": solver,
        "dset": {"name": "Clarity", "wav": data_root, "split": [0.5, 0.17, 0.33],
                 "segment": 0.25, "audio_channels": 2, "mode": "deverb"}}))


@pytest.mark.parametrize("name", ["crn", "mel-rnn", "sepformer"])
def test_trains_and_tests_through_main(tmp_path, name):
    if name != "sepformer":
        root = make_voicebank_demand(str(tmp_path / "data"), n_utterances=8, min_seconds=0.6,
                                     max_seconds=0.9, seed=2)
    else:
        root = make_clarity(str(tmp_path / "data"), n_scenes=8, seconds=0.5, seed=2)
    solver = main(_config(name, root, str(tmp_path / "run")), mode="train",
                  return_solver=True, device="cpu")
    assert solver.use_pit == (name == "sepformer")
    assert solver.epoch_stats[0]["train_steps"] == 2 and solver._global_step == 2
    assert all(np.isfinite(solver.scores["train_loss"] + solver.scores["val_loss"]))
    files = os.listdir(solver.checkpoint_dir)
    assert {"latest_model.ckpt", "best_model.ckpt", "state.json"} <= set(files)
    assert any(f.startswith("model_0000_loss_") for f in files)

    summary = solver.inference(save=True)
    rows = list(csv.DictReader(open(os.path.join(solver.run_dir, "results.csv"))))
    assert len(rows) == 2 and all(np.isfinite(float(r["sisdr_enhance"])) for r in rows)
    assert json.load(open(os.path.join(solver.run_dir, "test_summary.json"))) == summary
    assert len(os.listdir(os.path.join(solver.run_dir, "enhanced"))) == 2
