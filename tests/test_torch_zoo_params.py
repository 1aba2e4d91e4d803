"""Every shipped config builds in the port with the JAX package's parameter
count (``param_count`` / ``param_megabytes`` against JAX's), and the zoo's
smoke CLI runs.

The JAX count comes from ``jax.eval_shape(model.init, ...)`` (traced, not
compiled) on the input ``python -m speech_enhancement_tpu.models`` feeds
the model: a mono or stereo random waveform, through ``stft_custom`` for an
stft-domain model.
"""

import glob
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from speech_enhancement_torch.config import load_config
from speech_enhancement_torch.models import (build_model, model_names, param_count,
                                             param_megabytes)
from speech_enhancement_tpu.config import load_config as jax_load_config
from speech_enhancement_tpu.models import build_model as jax_build_model
from speech_enhancement_tpu.models import model_names as jax_model_names
from speech_enhancement_tpu.models import param_count as jax_param_count
from speech_enhancement_tpu.models import param_megabytes as jax_param_megabytes
from speech_enhancement_tpu.ops.stft import stft_custom as jax_stft_custom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 if not p.endswith("ha_clarity.yaml"))
# the counts these tests pin (chip_smoke.py logs them beside the card's build)
PARAMS = {"conv_tasnet_clarity.yaml": 1012508, "crn_vbd.yaml": 52194755,
          "dccrn_vbd.yaml": 2069757, "dcunet_vbd.yaml": 1966270,
          "demucs_clarity.yaml": 133751012, "dnn_vbd.yaml": 2699781,
          "mel_rnn_vbd.yaml": 1182467, "rnn_stft_mask_clarity.yaml": 47725058,
          "sepformer_clarity.yaml": 25687553, "tcn_vbd.yaml": 535617,
          "unet_vbd.yaml": 1959142, "wav_unet_vbd.yaml": 10132802}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_registry_is_the_jax_registry():
    assert model_names() == jax_model_names()
    assert sorted(PARAMS) == CONFIGS and len(CONFIGS) == 12


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_config_has_the_jax_parameter_count(name):
    path = os.path.join(REPO, "configs", name)
    jax_cfg = jax_load_config(path)
    model, spec = jax_build_model(jax_cfg.model)
    channels = int(jax_cfg.dset.get("audio_channels", 1))

    def init(wav):
        inputs = jax_stft_custom(wav, jax_cfg.model) if spec.domain == "stft" else wav
        return model.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, inputs)["params"]

    shapes = jax.eval_shape(init, jax.ShapeDtypeStruct((1, channels, 8000), jnp.float32))
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    port, port_spec = build_model(load_config(path).model, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == want == PARAMS[name]
    assert param_count(port) == jax_param_count(shapes) == want
    assert param_megabytes(port) == pytest.approx(jax_param_megabytes(shapes), rel=1e-12)
    assert port_spec == type(port).SPEC and port_spec.domain == spec.domain
    assert (port_spec.multi_speaker, port_spec.monarch) == (spec.multi_speaker, spec.monarch)


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "speech_enhancement_torch.models", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


@pytest.mark.parametrize("name", ["unet", "tcn"])
def test_models_smoke_cli_on_the_cpu(name):
    """One stft-domain and one wav-domain family through the smoke CLI."""
    proc = _cli(name, "--device", "cpu", "--seconds", "0.3")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert name in proc.stdout and "params" in proc.stdout and "out (1, " in proc.stdout


def test_models_smoke_cli_defaults_to_the_card():
    """Without ``--device`` the CLI asks for the card: on a host with none it
    exits non-zero with the device rule's message, never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    proc = _cli("tcn", "--seconds", "0.3", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stdout + proc.stderr
    assert "out (1, " not in proc.stdout
