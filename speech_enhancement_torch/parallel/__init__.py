"""Data parallelism over ``torch.distributed`` (counterpart of
speech_enhancement_tpu/parallel)."""

from speech_enhancement_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
    shard_batch,
    shard_train_step,
)
