"""The parallel layer on torch.distributed (the port of zutis_tpu/parallel/):
a data x model mesh of processes, one a device, and the DP and TP sharding
of ZUTIS training (mesh.py, dp.py, tp.py); sequence-parallel attention
(sp.py)."""
from zutis_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    close_mesh,
    create_mesh,
    gather_params,
    gather_train_state,
    mesh_of,
    param_partition_spec,
    replicate,
    shard_batch,
    shard_model,
    shard_params,
    shard_train_state,
)
