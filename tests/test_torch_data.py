"""The port's data layer vs the JAX package's, on the CPU.

The synthetic fixtures must be byte-identical for the same seeds; the wav
reader, the datasets' items, the factories' splits, the segment loader's
batches (f32 and int16 wire, training and validation with its masked tail,
decode threads or none, over two epochs) and the eval loader's order must
be equal; so must the host utilities.
"""

import os
import wave

import numpy as np
import pytest

from speech_enhancement_torch import utils as port_utils
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.data import dataset as port_dataset
from speech_enhancement_torch.data import loader as port_loader
from speech_enhancement_torch.data import native as port_native
from speech_enhancement_torch.data import synthetic as port_synthetic
from speech_enhancement_torch.data import wav_io as port_wav_io
from speech_enhancement_tpu import utils as jax_utils
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.data import dataset as jax_dataset
from speech_enhancement_tpu.data import loader as jax_loader
from speech_enhancement_tpu.data import native as jax_native
from speech_enhancement_tpu.data import synthetic as jax_synthetic
from speech_enhancement_tpu.data import wav_io as jax_wav_io


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, root)] = handle.read()
    return out


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The port's fixtures: 7 VoiceBank-DEMAND-like utterances of 0.6 to
    1.4 s and 5 Clarity scenes of 0.7 s (their files were checked equal to
    the JAX package's in the first test)."""
    base = tmp_path_factory.mktemp("torch_data")
    vbd = port_synthetic.make_voicebank_demand(str(base / "vbd"), n_utterances=7,
                                               min_seconds=0.6, max_seconds=1.4, seed=4)
    clarity = port_synthetic.make_clarity(str(base / "clarity"), n_scenes=5, seconds=0.7,
                                          seed=5)
    return {"vbd": vbd, "clarity": clarity}


@pytest.mark.parametrize("kind", ["voicebank_demand", "clarity", "ha_config"])
def test_synthetic_fixtures_are_byte_identical(tmp_path, kind):
    builders = {
        "voicebank_demand": lambda m, root: m.make_voicebank_demand(
            root, n_utterances=3, min_seconds=0.3, max_seconds=0.6, channels=2, seed=11),
        "clarity": lambda m, root: m.make_clarity(root, n_scenes=2, seconds=0.4, seed=12),
        "ha_config": lambda m, root: m.make_ha_config(
            root, scenes=["S00001", "S00002", "S00003"], n_listeners=3, seed=13),
    }
    build = builders[kind]
    build(port_synthetic, str(tmp_path / "port"))
    build(jax_synthetic, str(tmp_path / "jax"))
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port and sorted(port) == sorted(ref)
    # make_ha_config writes its root into ha.yaml: compare with it swapped
    for name, blob in port.items():
        assert blob.replace(b"/port", b"/jax") == ref[name], name


def _write_24bit(path, data, sr):
    ints = np.round(np.clip(data.T, -1, 1 - 2**-23) * 2**23).astype(np.int32).reshape(-1)
    raw = np.stack([ints & 0xFF, (ints >> 8) & 0xFF, (ints >> 16) & 0xFF], axis=-1)
    with wave.open(path, "wb") as handle:
        handle.setnchannels(data.shape[0])
        handle.setsampwidth(3)
        handle.setframerate(sr)
        handle.writeframes(raw.astype(np.uint8).tobytes())


@pytest.mark.parametrize("native", [True, False])
def test_read_wav_matches(tmp_path, rng, monkeypatch, native):
    if native:
        assert port_native.available() and jax_native.available()
    else:
        monkeypatch.setenv("SE_TPU_NO_NATIVE", "1")
    x = (0.4 * rng.standard_normal((2, 1777))).astype(np.float32)
    files = []
    for dtype in ("float32", "int16"):
        path = str(tmp_path / f"{dtype}.wav")
        port_wav_io.write_wav(path, x, 8000, dtype=dtype)
        files.append(path)
    path = str(tmp_path / "pcm24.wav")
    _write_24bit(path, x, 22050)
    files.append(path)
    for path in files:
        got, sr = port_wav_io.read_wav(path)
        want, want_sr = jax_wav_io.read_wav(path)
        assert sr == want_sr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=path)
    got, _ = port_wav_io.read_wav(files[-1])
    # the 24-bit file reads back to within its rounding
    np.testing.assert_allclose(got, np.clip(x, -1, 1 - 2**-23), atol=2**-23)
    assert port_wav_io.find_wav_files(str(tmp_path)) == jax_wav_io.find_wav_files(str(tmp_path))


def test_native_resample_and_zscore_match(rng):
    x = (0.3 * rng.standard_normal((2, 4410))).astype(np.float32)
    np.testing.assert_array_equal(port_native.resample(x, 44100, 16000),
                                  jax_native.resample(x, 44100, 16000))
    for got, want in zip(port_native.normalize_zscore(x.copy()),
                         jax_native.normalize_zscore(x.copy())):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["z-score", "linear-scale", ""])
def test_normalize_and_denormalize_match(rng, mode):
    x = (0.3 * rng.standard_normal((2, 3, 500)) + 0.1).astype(np.float32)
    got, got_meta = port_dataset.normalize_with_meta(x, mode)
    want, want_meta = jax_dataset.normalize_with_meta(x, mode)
    np.testing.assert_array_equal(got, want)
    _assert_items_equal(got_meta, want_meta)
    np.testing.assert_array_equal(port_dataset.denormalize(got, got_meta, mode),
                                  jax_dataset.denormalize(want, want_meta, mode))


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_items_equal(got[key], value)
        elif isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert np.array_equal(got[key], value), key


def _dset(root, name="VoiceBankDEMAND", **extra):
    return {"name": name, "wav": root, "split": [0.5, 0.25, 0.25], "segment": 0.5,
            "audio_channels": 1 if name != "Clarity" else 2, "sample_rate": 16000,
            "norm": "z-score", **extra}


@pytest.mark.parametrize("case", ["vbd", "vbd_linear", "clarity_se", "clarity_deverb"])
def test_datasets_and_splits_match(fixtures, case):
    """Every item of the three splits (train items over two epochs of crops)."""
    if case.startswith("vbd"):
        dset = _dset(fixtures["vbd"], norm="linear-scale" if case == "vbd_linear" else "z-score")
    else:
        dset = _dset(fixtures["clarity"], "Clarity", mode=case.split("_")[1])
    got = port_loader.get_train_wav_dataset(Config(dset), None, seed=3)
    want = jax_loader.get_train_wav_dataset(JaxConfig(dset), None, seed=3)
    for split, (g, w) in enumerate(zip(got, want)):
        files = "entries" if case.startswith("clarity") else "mixture_files"
        assert getattr(g, files) == getattr(w, files) and len(g) > 0, split
        for epoch in (0, 5):
            g.set_epoch(epoch)
            w.set_epoch(epoch)
            for i in range(len(w)):
                _assert_items_equal(g[i], w[i])
    if case == "clarity_se":
        dev_got = port_loader.get_dev_wav_clarity(Config(dset), seed=3)
        dev_want = jax_loader.get_dev_wav_clarity(JaxConfig(dset), seed=3)
        assert dev_got.entries == dev_want.entries
        _assert_items_equal(dev_got[1], dev_want[1])


def _flat(batch):
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out.update({f"{key}.{k}": v for k, v in value.items()})
        else:
            out[key] = value
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("validation", [False, True])
@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_segment_loader_batches_match(fixtures, wire, validation, num_workers):
    """Two epochs of batches through each package's get_dataloader. Segments
    of 0.2 s from 0.5 s crops: three a crop, carried over between batches
    of 4; validation keeps the last batch, zero-padded and masked."""
    dset = _dset(fixtures["vbd"], wire=wire, segment=0.5)
    solver = {"batch_size": 4, "num_workers": num_workers}
    loaders = []
    for pkg_loader, cfg_cls in ((port_loader, Config), (jax_loader, JaxConfig)):
        cfg = cfg_cls({"dset": dset, "solver": solver})
        train_set, val_set, _ = pkg_loader.get_train_wav_dataset(cfg.dset, None, seed=9)
        cfg.dset.segment = 0.2
        loaders.append(pkg_loader.get_dataloader(val_set if validation else train_set, cfg,
                                                 train=True, seed=9, validation=validation))
    got_loader, want_loader = loaders
    assert got_loader.num_workers == num_workers and got_loader.wire == wire
    masks = 0
    for epoch in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0, epoch
        for g, w in zip(got, want):
            g, w = _flat(g), _flat(w)
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{epoch} {key}")
            masks += "mask" in w
    assert masks == (2 if validation else 0)


def test_eval_loader_order_and_wire(fixtures, rng):
    dset = _dset(fixtures["vbd"])
    got = port_loader.get_train_wav_dataset(Config(dset), None, seed=1)[2]
    want = jax_loader.get_train_wav_dataset(JaxConfig(dset), None, seed=1)[2]
    for prefetch in (0, 2):
        items = list(zip(port_loader.EvalLoader(got, prefetch=prefetch),
                         jax_loader.EvalLoader(want, prefetch=prefetch)))
        assert len(items) == len(want) > 1
        for g, w in items:
            _assert_items_equal(g, w)
    x = (0.3 * rng.standard_normal((3, 2, 1000))).astype(np.float32)
    _assert_items_equal(port_loader.encode_wire_int16(x), jax_loader.encode_wire_int16(x))
    np.testing.assert_array_equal(port_loader.segment_item(x, 300),
                                  jax_loader.segment_item(x, 300))


def test_shard_for_process_matches():
    items = list(range(23))
    for count in (1, 3, 4):
        for index in range(count):
            assert port_loader.shard_for_process(items, index, count) == \
                jax_loader.shard_for_process(items, index, count)
    # no torch.distributed process group: the identity, as one JAX process
    assert port_loader.shard_for_process(items) == items


def test_utils_match(tmp_path, rng):
    x = rng.standard_normal((2, 3, 7)).astype(np.float32)
    np.testing.assert_array_equal(port_utils.pad_last(x, 11, 0.5), jax_utils.pad_last(x, 11, 0.5))
    assert port_utils.split_list(list(range(17)), [0.5, 0.3, 0.2]) == \
        jax_utils.split_list(list(range(17)), [0.5, 0.3, 0.2])
    for length in (5, 7):
        crops = [m.sample_fixed_length_data_aligned(x, 2 * x, length, np.random.default_rng(8))
                 for m in (port_utils, jax_utils)]
        for got, want in zip(*crops):
            np.testing.assert_array_equal(got, want)
    (tmp_path / "a" / "logs").mkdir(parents=True)
    (tmp_path / "b" / "c" / "logs").mkdir(parents=True)
    assert sorted(port_utils.find_folder("logs", str(tmp_path))) == \
        sorted(jax_utils.find_folder("logs", str(tmp_path)))
    (tmp_path / "log_trainset_28spk.txt").write_text("p1_001 a 0\np1_002 b 5\np1_003 c 2\n")
    assert port_utils.get_filtered_snr_file("VoiceBankDEMAND", str(tmp_path)) == \
        jax_utils.get_filtered_snr_file("VoiceBankDEMAND", str(tmp_path)) == ["p1_001", "p1_003"]
    assert [port_utils.human_bytes(n) for n in (3, 5e6, 7e13)] == \
        [jax_utils.human_bytes(n) for n in (3, 5e6, 7e13)]
    import torch

    a = (port_utils.seed_everything(5).random(), torch.rand(2))
    b = (port_utils.seed_everything(5).random(), torch.rand(2))
    assert a[0] == b[0] == jax_utils.seed_everything(5).random() and torch.equal(a[1], b[1])
