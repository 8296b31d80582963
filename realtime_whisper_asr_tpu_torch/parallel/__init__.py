"""Multi-rank parallelism over ``torch.distributed``: the mesh, Megatron
tensor and sequence parallelism, GPipe stages.

Port of ``realtime_whisper_asr_tpu/parallel``. The JAX package shards over a
``jax.sharding.Mesh`` and XLA inserts the collectives; here each device is a
process of one ``torch.distributed`` world (NCCL on the card, gloo on the
CPU), the parameters are sliced per rank (``sharding``), and the model's
tensor-parallel modules (``tp``) and the pipeline's schedule call the
collectives themselves (``collectives``). Entry points run on the card
unless asked for the CPU; the single-card path issues no collective.
"""

from realtime_whisper_asr_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from realtime_whisper_asr_tpu_torch.parallel.pipeline import (
    StageMesh,
    make_pp_mesh,
    make_pp_train_state,
    make_pp_train_step,
    pipeline_blocks,
    pp_decode_full,
    pp_encode,
    pp_param_shardings,
)
from realtime_whisper_asr_tpu_torch.parallel.sharding import (
    data_sharding,
    gather_params,
    sequence_sharding,
    shard_model,
    shard_params,
    whisper_param_shardings,
)
