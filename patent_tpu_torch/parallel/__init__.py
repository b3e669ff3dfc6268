"""Meshes, sharding rules and sharded training on ``torch.distributed``
(port of patent_tpu/parallel): ``launch.run_world`` starts a world of
ranks, ``mesh`` holds the mesh and the row-block rules, ``sharded_train``
the sharded train_hyp step, ``dryrun`` the multi-rank dry run."""

from .launch import run_world  # noqa: F401
from .mesh import (  # noqa: F401
    data_parallel_sharding,
    encode_sharded,
    label_table_sharding,
    make_mesh,
    shard_batch,
)
from .sharded_train import (  # noqa: F401
    make_hyp_mesh,
    make_sharded_train_step,
    pad_label_table,
    shard_hyp_state,
)
