"""Fixed-shape batching + prefetching loader and dataset factories
(counterpart of speech_enhancement_tpu/data/loader.py; the same batches,
bit for bit, for the same dataset and seed).

The reference's collate (src/distrib.py:38-98) pads each utterance to a
multiple of the segment length, splits it into segments and concatenates
*all* segments of all items — so the effective batch size is data-dependent
(SURVEY §6b.6). Here the same semantics (every segment of every utterance
is trained on) are kept, but segments flow through a pool that emits
*exactly* ``batch_size`` segments per step: one shape, so the kernels'
launch plans and the allocator's blocks are reused from step to step.
Leftover segments carry over to the next batch; in training the final
partial batch of an epoch is dropped, in eval it is zero-padded + masked.

A background thread prefetches host batches so wav decode / resample /
normalize overlaps device compute (the reference uses torch DataLoader
workers, src/distrib.py:212-224).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from speech_enhancement_torch.data.dataset import ClarityWavDataset, WavDataset
from speech_enhancement_torch.utils import pad_last, split_list


def segment_item(array: np.ndarray, segment_length: int) -> np.ndarray:
    """Pad [..., T] to a segment multiple and split: -> [n_seg, ..., seg_len].

    Mirrors collate_fn_pad's per-item reshape (src/distrib.py:55-75).
    """
    length = array.shape[-1]
    n_seg = max(1, -(-length // segment_length))
    array = pad_last(array, n_seg * segment_length)
    segments = array.reshape(*array.shape[:-1], n_seg, segment_length)
    return np.moveaxis(segments, -2, 0)


def encode_wire_int16(arr: np.ndarray) -> Dict[str, np.ndarray]:
    """f32 [..., L] -> {"q": int16, "scale": f32 [..., 1]} wire encoding.

    Audio is 16-bit at origin, so a per-(item, channel) peak-scaled int16
    wire halves the host->device bytes of an f32 batch; the device decodes
    with one multiply (``train.solver.decode_wire``). Quantization error is
    <= peak/65534 (~90 dB below segment peak — the fidelity class of the
    source PCM).
    """
    peak = np.max(np.abs(arr), axis=-1, keepdims=True)
    scale = (np.maximum(peak, 1e-9) / 32767.0).astype(np.float32)
    q = np.round(arr / scale).astype(np.int16)
    return {"q": q, "scale": scale}


class SegmentLoader:
    """Iterates a dataset, yielding fixed-shape segment batches.

    Yields dicts with ``mixture`` [B, C, L] and ``sources`` [B, S, C, L]
    float32 numpy arrays (the reference's train-batch contract,
    src/distrib.py:91-97, with B now constant). With ``wire="int16"`` the
    two arrays are wire-encoded (see :func:`encode_wire_int16`); the train
    step decodes on the device.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        segment_length: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        prefetch: int = 2,
        wire: str = "f32",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.segment_length = segment_length
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.wire = wire
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        # Upper-bound estimate; exact count depends on utterance lengths.
        return max(1, len(self.dataset))

    def _iter_items(self, order: np.ndarray) -> Iterator[Dict[str, np.ndarray]]:
        """Decode dataset items, optionally on ``num_workers`` threads.

        Wav decode + resample + normalize are numpy/libsndfile work that
        releases the GIL, so a small thread pool overlaps decode of the next
        items with batching of the current one (the reference's counterpart
        is torch DataLoader worker processes, src/distrib.py:212-224).
        Order is preserved.
        """
        if self.num_workers <= 0:
            for idx in order:
                yield self.dataset[int(idx)]
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers * 2
            futures = [
                pool.submit(self.dataset.__getitem__, int(idx))
                for idx in order[:window]
            ]
            pos = window
            while futures:
                yield futures.pop(0).result()
                if pos < len(order):
                    futures.append(
                        pool.submit(self.dataset.__getitem__, int(order[pos]))
                    )
                    pos += 1

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            # advance per-epoch crop RNG streams (order-independent crops)
            self.dataset.set_epoch(self._seed + self._epoch)
        self._epoch += 1

        pool_mix: List[np.ndarray] = []
        pool_src: List[np.ndarray] = []
        for item in self._iter_items(order):
            mix = item["mixture"]
            src = item["sources"]
            if mix.shape[-1] < self.segment_length:
                mix = pad_last(mix, self.segment_length)
                src = pad_last(src, self.segment_length)
            pool_mix.extend(segment_item(mix, self.segment_length))
            pool_src.extend(segment_item(src, self.segment_length))
            while len(pool_mix) >= self.batch_size:
                batch_mix = np.stack(pool_mix[: self.batch_size])
                batch_src = np.stack(pool_src[: self.batch_size])
                del pool_mix[: self.batch_size], pool_src[: self.batch_size]
                yield self._emit(batch_mix, batch_src)
        if pool_mix and not self.drop_last:
            n = len(pool_mix)
            pad = self.batch_size - n
            batch_mix = np.stack(pool_mix + [np.zeros_like(pool_mix[0])] * pad)
            batch_src = np.stack(pool_src + [np.zeros_like(pool_src[0])] * pad)
            mask = np.zeros(self.batch_size, np.float32)
            mask[:n] = 1.0
            yield self._emit(batch_mix, batch_src, mask)

    def _emit(self, batch_mix, batch_src, mask=None) -> Dict[str, np.ndarray]:
        if self.wire == "int16":
            batch = {"mixture": encode_wire_int16(batch_mix),
                     "sources": encode_wire_int16(batch_src)}
        else:
            batch = {"mixture": batch_mix, "sources": batch_src}
        if mask is not None:
            batch["mask"] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []

        def worker():
            try:
                for batch in self._iter_batches():
                    q.put(batch)
            except BaseException as exc:  # surface loader errors in the consumer
                error.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            batch = q.get()
            if batch is sentinel:
                break
            yield batch
        thread.join()
        if error:
            raise error[0]


class EvalLoader:
    """Batch-size-1 full-utterance iterator (reference: distrib.py:212-224,
    eval path uses batch_size=1 and no collate).

    A small prefetch thread decodes/resamples utterance k+1 while the
    consumer drives the device for utterance k, so the host decode is off
    the inference critical path (same pattern as SegmentLoader's
    prefetcher). ``prefetch=0`` restores the synchronous iterator.
    """

    def __init__(self, dataset, prefetch: int = 2):
        self.dataset = dataset
        self.prefetch = int(prefetch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self):
        if self.prefetch <= 0:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []

        def worker():
            try:
                for i in range(len(self.dataset)):
                    q.put(self.dataset[i])
            except BaseException as exc:  # surface in the consumer
                error.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if error:
            raise error[0]


def get_train_wav_dataset(dset_config, model_config, seed: int = 0):
    """Build (train, validation, test) datasets (reference: distrib.py:100-210).

    VoiceBank-DEMAND: mixture/clean dirs split by ``dset.split`` ratios.
    Clarity: scene lists from custom metadata JSON.
    """
    sample_length = int(dset_config.sample_rate * dset_config.segment)
    name = str(dset_config.name).lower()
    if name in ("voicebankdemand", "vbd", "synthetic"):
        import os

        root = dset_config.wav
        mix_dir = os.path.join(root, "noisy_trainset_wav")
        clean_dir = os.path.join(root, "clean_trainset_wav")
        if not os.path.exists(mix_dir):  # flat layout fallback
            mix_dir = os.path.join(root, "mixture")
            clean_dir = os.path.join(root, "clean")
        from speech_enhancement_torch.data.wav_io import find_wav_files

        total = len(find_wav_files(mix_dir))
        ratios = [float(r) for r in dset_config.split]
        splits = split_list(list(range(total)), ratios)
        # several hosts: each trains on a disjoint shard of the train
        # split; val/test stay whole so every process reports the same
        # validation loss (one host: identity)
        splits[0] = shard_for_process(splits[0])
        common = dict(
            mixture_dataset=mix_dir,
            clean_dataset=clean_dir,
            normalize=dset_config.norm,
            sample_rate=dset_config.sample_rate,
            audio_channels=dset_config.audio_channels,
            seed=seed,
        )
        train_set = WavDataset(
            scenes=splits[0], sample_length=sample_length, train=True, **common
        )
        val_set = WavDataset(
            scenes=splits[1], sample_length=sample_length, train=True, **common
        )
        test_set = WavDataset(scenes=splits[2], sample_length=None, train=False, **common)
        return train_set, val_set, test_set

    if name == "clarity":
        import json
        import os

        root = dset_config.wav
        meta = os.path.join(root, "custom_metadata", "scenes.train.json")
        with open(meta) as handle:
            scenes = json.load(handle)
        ratios = [float(r) for r in dset_config.split]
        splits = split_list(scenes, ratios)
        splits[0] = shard_for_process(splits[0])  # per-host train shard
        common = dict(
            path_dataset=root,
            normalize=dset_config.norm,
            sample_rate=dset_config.sample_rate,
            audio_channels=dset_config.audio_channels,
            type_dataset=dset_config.get("mode", "se"),
            seed=seed,
        )
        train_set = ClarityWavDataset(
            scenes=splits[0], sample_length=sample_length, train=True, **common
        )
        val_set = ClarityWavDataset(
            scenes=splits[1], sample_length=sample_length, train=True, **common
        )
        test_set = ClarityWavDataset(
            scenes=splits[2], sample_length=None, train=False, **common
        )
        return train_set, val_set, test_set

    raise ValueError(f"unknown dataset {dset_config.name!r}")


def get_dev_wav_clarity(dset_config, seed: int = 0):
    """Clarity dev-set dataset (reference: distrib.py:185-200 get_dev_wav_clarity)."""
    import json
    import os

    root = dset_config.wav
    meta = os.path.join(root, "custom_metadata", "scenes.dev.json")
    if not os.path.exists(meta):
        meta = os.path.join(root, "custom_metadata", "scenes.train.json")
    with open(meta) as handle:
        scenes = json.load(handle)
    return ClarityWavDataset(
        path_dataset=root,
        scenes=scenes,
        sample_length=None,
        normalize=dset_config.norm,
        sample_rate=dset_config.sample_rate,
        audio_channels=dset_config.audio_channels,
        train=False,
        dev_clarity=True,
        type_dataset=dset_config.get("mode", "se"),
        seed=seed,
    )


def get_dataloader(dataset, config, train: bool = True, seed: int = 0,
                   validation: bool = False):
    """Loader factory (reference: distrib.py:212-224).

    Validation loaders keep the tail batch (zero-padded + masked) so every
    segment is counted in the epoch val loss exactly once; training drops
    only the final partial batch of the epoch (fixed-shape batching).
    """
    if not train:
        return EvalLoader(dataset)
    segment_length = int(config.dset.sample_rate * config.dset.segment)
    return SegmentLoader(
        dataset,
        batch_size=int(config.solver.batch_size),
        segment_length=segment_length,
        shuffle=not validation,
        drop_last=not validation,
        seed=seed,
        num_workers=int(config.solver.get("num_workers", 0) or 0),
        wire=str(config.dset.get("wire", "f32") or "f32"),
    )


def shard_for_process(items: Sequence, index: Optional[int] = None,
                      count: Optional[int] = None) -> list:
    """Disjoint per-host shard of a file/scene list.

    Each host loads only every ``count``-th item, so the global batch is
    assembled from disjoint host shards (SURVEY §2c). A host is what a JAX
    process is: one machine driving all of its devices. ``index`` and
    ``count`` default to this host's index and the number of hosts
    (``parallel/mesh.py:host_index_count``: rank // ``LOCAL_WORLD_SIZE``
    over world size // ``LOCAL_WORLD_SIZE``; without torchrun's
    ``LOCAL_WORLD_SIZE`` the group counts as one host). With one host this
    is the identity, and every rank of the host reads the whole list.
    """
    if index is None:
        from speech_enhancement_torch.parallel.mesh import host_index_count

        index, count = host_index_count()
    count = max(int(count or 1), 1)
    return list(items)[index::count]
