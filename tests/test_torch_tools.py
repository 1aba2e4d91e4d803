"""The port's user tools and public helpers vs the JAX package's, on the CPU.

``tools/prepare_data.py`` (the repository's JAX tool, loaded by path and
left as it is) against ``speech_enhancement_torch.tools.prepare_data`` on
a synthetic 48 kHz VoiceBank-DEMAND tree and a Clarity tree: the same
files, samples within 2e-6 (a float WAV keeps f32; the two resample in
f32 and f64), the same metadata, the same JSON line. The inference tool on
a one-step CPU run of a small DCCRN against JAX's ``evaluate_utterance``
with the run's weights carried across by ``dccrn_from_torch_state``, within
tests/test_torch_evaluate.py's bound. Then ``si_sdr_torch``,
``ClarityScorer.amplify_for_listener``, ``get_model_class``,
``param_count`` and ``param_megabytes`` against their JAX twins (every
shipped config's counts: tests/test_torch_zoo_params.py).
"""

import glob
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.config import load_config as jax_load_config
from speech_enhancement_tpu.data.synthetic import make_ha_config as jax_make_ha_config
from speech_enhancement_tpu.ha.scoring import ClarityScorer as JaxClarityScorer
from speech_enhancement_tpu.models import build_model as jax_build_model
from speech_enhancement_tpu.models import get_model_class as jax_get_model_class
from speech_enhancement_tpu.models import model_names as jax_model_names
from speech_enhancement_tpu.models import param_count as jax_param_count
from speech_enhancement_tpu.models import param_megabytes as jax_param_megabytes
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_tpu.train.metrics import si_sdr_jax
from speech_enhancement_torch.config import Config, load_config, with_defaults
from speech_enhancement_torch.data.synthetic import (make_clarity, make_ha_config,
                                                     make_voicebank_demand)
from speech_enhancement_torch.data.wav_io import read_wav, write_wav
from speech_enhancement_torch.ha.scoring import ClarityScorer
from speech_enhancement_torch.main import main as port_main
from speech_enhancement_torch.models import (build_model, get_model_class, param_count,
                                             param_megabytes)
from speech_enhancement_torch.tools import inference, prepare_data
from speech_enhancement_torch.train import checkpoints as ckpt
from speech_enhancement_torch.train.metrics import si_sdr_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"name": "dccrn", "kernel_num": [8, 16], "rnn_units": 16, "segment": 1,
         "win_length": 512}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool():
    """The repository's tools/prepare_data.py, loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_prepare_data",
                                                  os.path.join(REPO, "tools", "prepare_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpus48(tmp_path_factory):
    """A 48 kHz VoiceBank-DEMAND tree with train and test folders."""
    root = str(tmp_path_factory.mktemp("vbd48"))
    make_voicebank_demand(root, n_utterances=3, sr=48000, min_seconds=0.2, max_seconds=0.4,
                          seed=4)
    for kind in ("noisy", "clean"):
        test_dir = os.path.join(root, f"{kind}_testset_wav")
        os.makedirs(test_dir)
        wav, sr = read_wav(os.path.join(root, f"{kind}_trainset_wav", "p000_000.wav"))
        write_wav(os.path.join(test_dir, "p001_000.wav"), wav[:, :9000], sr)
    return root


def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tree(root: str) -> list:
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if not os.path.isdir(p))


def test_prepare_vbd_resampled_matches_jax(corpus48, tmp_path, capsys):
    jax_dst, port_dst = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool().prepare_vbd(corpus48, jax_dst, 16000, False)
    want = _json_line(capsys)
    got = prepare_data.prepare_vbd(corpus48, port_dst, 16000, False, device="cpu")
    assert _json_line(capsys) == got
    assert got.pop("root") == port_dst and want.pop("root") == jax_dst
    assert got == want == {"dataset": "VoiceBank-DEMAND", "noisy_trainset_wav": 3,
                           "clean_trainset_wav": 3, "noisy_testset_wav": 1,
                           "clean_testset_wav": 1}
    files = _tree(port_dst)
    assert files == _tree(jax_dst) and len(files) == 8
    for name in files:
        (a, sr_a), (b, sr_b) = read_wav(os.path.join(port_dst, name)), read_wav(
            os.path.join(jax_dst, name))
        src, _ = read_wav(os.path.join(corpus48, name))
        assert sr_a == sr_b == 16000 and a.shape == b.shape
        assert a.shape[-1] == -(-src.shape[-1] // 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("copy", [False, True])
def test_prepare_vbd_places_files_as_jax(corpus48, tmp_path, capsys, copy):
    jax_dst, port_dst = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool().prepare_vbd(corpus48, jax_dst, 0, copy)
    want = _json_line(capsys)
    got = prepare_data.prepare_vbd(corpus48, port_dst, 0, copy)  # no resample: no device
    capsys.readouterr()
    assert {**got, "root": None} == {**want, "root": None}
    assert _tree(port_dst) == _tree(jax_dst)
    for name in _tree(port_dst):
        path = os.path.join(port_dst, name)
        assert os.path.islink(path) != copy
        assert os.path.islink(path) == os.path.islink(os.path.join(jax_dst, name))
        with open(path, "rb") as a, open(os.path.join(corpus48, name), "rb") as b:
            assert a.read() == b.read()


def test_prepare_clarity_matches_jax(tmp_path, capsys):
    """Scenes, the custom metadata (one target span from the package's
    scenes.train.json, the rest from the WAVs) and the HA metadata."""
    src = str(tmp_path / "src")
    make_clarity(src, n_scenes=3, seconds=0.3, seed=5)
    make_ha_config(src, scenes=["S00001", "S00002", "S00003"], n_listeners=2)
    with open(os.path.join(src, "metadata", "scenes.train.json"), "w") as fh:
        json.dump([{"scene": "S00002", "target": {"time_start": 100, "time_end": 3000}}], fh)
    jax_dst, port_dst = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool().prepare_clarity_tree(src, jax_dst, False)
    want = _json_line(capsys)
    got = prepare_data.prepare_clarity_tree(src, port_dst, False)
    capsys.readouterr()
    assert {**got, "root": None} == {**want, "root": None}
    assert got["train"] == got["dev"] == 3 and got["listeners.json"] is True
    assert _tree(port_dst) == _tree(jax_dst)
    for name in glob.glob(os.path.join(port_dst, "custom_metadata", "*.json")):
        with open(name) as a, open(os.path.join(jax_dst, os.path.relpath(name, port_dst))) as b:
            assert json.load(a) == json.load(b), name
    with open(os.path.join(port_dst, "custom_metadata", "scenes.train.time.json")) as fh:
        spans = json.load(fh)
    assert spans["S00002"] == [100, 3000] and spans["S00001"] == [0, 4800]


def test_prepare_data_command_line(corpus48, tmp_path):
    """``python -m`` in a subprocess, which imports no JAX; the default
    device is the card, so resampling without one raises."""
    dst = str(tmp_path / "cli")
    code = ("import runpy, sys; sys.argv = ['prepare_data'] + sys.argv[1:]; "
            "runpy.run_module('speech_enhancement_torch.tools.prepare_data', "
            "run_name='__main__'); "
            "assert not {'jax', 'flax', 'speech_enhancement_tpu'} & set(sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code, "vbd", "--src", corpus48, "--dst", dst,
                           "--sample-rate", "16000", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["clean_trainset_wav"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prepare_data.main(["vbd", "--src", corpus48, "--dst", str(tmp_path / "x"),
                               "--sample-rate", "16000"])


# -- the inference tool ------------------------------------------------------------

@pytest.fixture(scope="module")
def one_step_run(tmp_path_factory):
    """A small DCCRN trained one step on the CPU through the port's main()."""
    root = str(tmp_path_factory.mktemp("tools_run"))
    vbd = make_voicebank_demand(os.path.join(root, "vbd"), n_utterances=6, min_seconds=1.1,
                                max_seconds=1.5, seed=6)
    cfg = with_defaults(Config({
        "seed": 7, "optim": {"optim": "adam", "lr": 1e-3, "loss": "mse", "clip_grad": 5},
        "model": SMALL,
        "dset": {"name": "VoiceBankDEMAND", "wav": vbd, "split": [0.5, 0.25, 0.25],
                 "segment": 1, "audio_channels": 1, "sample_rate": 16000, "norm": "z-score"},
        "solver": {"root": root, "epochs": 1, "batch_size": 2, "all_steps": False,
                   "total_steps": 1, "patience": 40,
                   "validation": {"total_steps": 1, "interval": 1, "metric": "loss"},
                   "test": {"total_steps": 0, "interval": 1, "num_show": 0,
                            "metric": "sisdr"}}}))
    run_dir = os.path.join(root, "run")
    port_main(cfg, mode="train", device="cpu", run_dir=run_dir)
    return run_dir, vbd


def test_inference_tool_matches_jax_evaluate(one_step_run, tmp_path, capsys):
    run_dir, vbd = one_step_run
    noisy = os.path.join(vbd, "noisy_trainset_wav", "p000_001.wav")
    clean = os.path.join(vbd, "clean_trainset_wav", "p000_001.wav")
    out = str(tmp_path / "enhanced.wav")
    inference.main(["--run-dir", run_dir, "--wav", noisy, "--out", out, "--clean", clean,
                    "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "wrote" in printed and "'sisdr'" in printed and "'stoi'" in printed
    got, sr = read_wav(out)
    wav, _ = read_wav(noisy)
    assert sr == 16000 and got.shape == wav.shape and np.isfinite(got).all()

    state = {k: v.numpy() for k, v in ckpt.model_state(ckpt.latest_checkpoint(run_dir)).items()}
    params, stats = jax_compat.dccrn_from_torch_state(state, n_encoder=2)
    jax_cfg = jax_load_config(os.path.join(run_dir, "config.yaml"))
    model, spec = jax_build_model(jax_cfg.model)
    want = jax_eval.evaluate_utterance(
        wav[None], lambda v, x: model.apply(v, x, train=False),
        {"params": params, "batch_stats": stats}, spec, jax_cfg)[0]
    np.testing.assert_allclose(got, want, atol=float(2e-4 * wav.std()))
    # the run trained: its statistics are not the initial ones
    port, _ = build_model(load_config(os.path.join(run_dir, "config.yaml")).model, device="cpu")
    assert not torch.equal(port.encoder[0][1].RMr, torch.from_numpy(state["encoder.0.1.RMr"]))


def test_inference_tool_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="latest_model.ckpt"):
        inference.enhance_file(str(tmp_path), "x.wav", "y.wav", device="cpu")


# -- public helpers ----------------------------------------------------------------

def test_si_sdr_torch_matches_jax(rng):
    ref = rng.standard_normal((3, 2, 1000)).astype(np.float32)
    est = (0.8 * ref + 0.3 * rng.standard_normal(ref.shape)).astype(np.float32)
    for r, e in ((ref, est), (ref[0, 0], est[0, 0]), (ref, ref)):
        got = si_sdr_torch(torch.from_numpy(r), torch.from_numpy(e))
        want = float(si_sdr_jax(jnp.asarray(r), jnp.asarray(e)))
        assert got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("channels", [1, 2])
def test_amplify_for_listener_matches_jax(tmp_path, rng, channels):
    """[C, T] at the HA rate -> [2, T'] (mono broadcast to both ears), within
    tests/test_torch_ha.py's 1e-5."""
    port = ClarityScorer(make_ha_config(str(tmp_path / "port"), scenes=["S00001"],
                                        n_listeners=1, fs=16000), input_sr=16000, device="cpu")
    ref = JaxClarityScorer(jax_make_ha_config(str(tmp_path / "jax"), scenes=["S00001"],
                                              n_listeners=1, fs=16000), input_sr=16000)
    listener = port.listeners_for_scene("S00001")[0]
    signal = (0.1 * rng.standard_normal((channels, 6000))).astype(np.float32)
    got = port.amplify_for_listener(signal, listener)
    want = ref.amplify_for_listener(signal, listener)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if channels == 1:  # the same as the signal on both ears (each ear its own audiogram)
        both = port.amplify_for_listener(np.concatenate([signal, signal]), listener)
        np.testing.assert_array_equal(got.numpy(), both.numpy())


def test_get_model_class_is_the_jax_registry():
    for name in jax_model_names():
        assert get_model_class(name).__name__ == jax_get_model_class(name).__name__
    with pytest.raises(ValueError, match="unknown model"):
        get_model_class("dccrn-x")


def test_param_count_and_megabytes_match_jax(one_step_run):
    run_dir, _ = one_step_run
    state = {k: v.numpy() for k, v in ckpt.model_state(ckpt.latest_checkpoint(run_dir)).items()}
    params, _ = jax_compat.dccrn_from_torch_state(state, n_encoder=2)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    port, _ = build_model(Config(SMALL), device="cpu")
    assert param_count(port) == jax_param_count(params) > 0
    assert param_megabytes(port) == pytest.approx(jax_param_megabytes(params), rel=1e-12)
    assert param_megabytes(port.to(torch.bfloat16)) == pytest.approx(
        jax_param_megabytes(jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)),
        rel=1e-12)
