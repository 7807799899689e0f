"""Data parallelism: counterpart of `kgtpu/parallel/`.

`mesh` lists the devices of a data-parallel run and splits and gathers a
batch over them (serving: one model replica per device, `infer.py`).
`multihost` joins a `torch.distributed` process group and gives a rank its
view of the global batch (training: one process per device, `train_lib`,
`cli/train.py`).  `launch` starts the ranks of one host.
"""

from kgtpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
from kgtpu_torch.parallel.multihost import (GlobalBatch, all_hosts_max, barrier,
                                            broadcast_scalar, global_batch, initialize,
                                            is_main, shutdown)

__all__ = ["make_mesh", "shard_batch", "gather_batch", "GlobalBatch", "initialize",
           "is_main", "broadcast_scalar", "all_hosts_max", "barrier", "global_batch",
           "shutdown"]
