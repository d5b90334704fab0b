"""Parallelism on ``torch.distributed`` (counterpart of
``openpsg_tpu/parallel``): meshes (:mod:`.mesh`), explicit collectives
(:mod:`.comm`), the Megatron tp plan (:mod:`.sharding`), the GPipe
pipeline (:mod:`.pipeline`) and the rank launcher (:mod:`.launch`)."""

from openpsg_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from openpsg_tpu_torch.parallel.sharding import (  # noqa: F401
    pair_sharded_range,
    param_sharding_rules,
    plan_shardings,
    shard_params,
)
