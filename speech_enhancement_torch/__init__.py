"""PyTorch/CUDA port of speech_enhancement_tpu for NVIDIA Hopper (H100).

The JAX package ``speech_enhancement_tpu`` is the reference; this package
mirrors its module names so each counterpart is easy to find, and never
imports JAX or anything from the JAX package. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; they raise when CUDA is
asked for and absent (see ``device.resolve_device``).

Ported so far (DCCRN inference through ``train/evaluate.py`` and its train
step through ``train/solver.py``): ``config``, ``models.types``,
``ops.frame``, ``ops.complex_ops``, ``ops.complex_conv``, ``ops.rnn``,
``models.dccrn``, ``compat.jax_weights``, ``train.evaluate``,
``train.losses``, ``train.solver``, and the hand-written CUDA kernels under
``kernels/``.
"""

from speech_enhancement_torch.device import resolve_device

__all__ = ["resolve_device"]
