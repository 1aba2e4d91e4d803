"""PyTorch/CUDA port of speech_enhancement_tpu for NVIDIA Hopper (H100).

The JAX package ``speech_enhancement_tpu`` is the reference; this package
mirrors its module names so each counterpart is easy to find, and never
imports JAX or anything from the JAX package. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; they raise when CUDA is
asked for and absent (see ``device.resolve_device``).

Ported so far: the twelve model families of the JAX registry
(``models``, ``ops``, ``compat.jax_weights``; ``python -m
speech_enhancement_torch.models`` builds and runs each) with the
hand-written CUDA kernels under ``kernels/``; the host data layer (``data``, ``utils``,
``config``); the engine (``train.solver.Solver``, ``train.evaluate``,
``train.losses``, ``train.metrics``, ``train.checkpoints``); streaming
serving (``serve``: ``DCCRNStreamer``, ``CRNStreamer``); the Clarity
hearing-aid chain (``ha``: NAL-R, compressor, HASPI / HASQI,
``ha.scoring.ClarityScorer``); data-parallel training over
``torch.distributed`` (``parallel``: DDP, one process a card, and the
multi-device dry run ``parallel.dryrun``); and the entry point
``main.main`` with its command line::

    python -m speech_enhancement_torch --config configs/dccrn_vbd.yaml --mode train
"""

from speech_enhancement_torch.device import resolve_device

__all__ = ["resolve_device"]
