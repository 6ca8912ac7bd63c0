"""Data parallelism over `torch.distributed` (counterpart of
`xggm_tpu/parallel/`): the process group and the rank's feed
(`distributed.py`), the data group and the ZeRO-1 layout (`mesh.py`).
Tensor and pipeline parallelism are not ported."""
from xggm_tpu_torch.parallel.distributed import (
    host_barrier, host_scalar, init_distributed, init_from_env,
    process_slice, shutdown_distributed, to_host)
from xggm_tpu_torch.parallel.mesh import (
    Mesh, axis_sharded_leaves, gathered_opt_state, make_mesh,
    maybe_zero_shard_state, pad_batch_to, zero_state_shardings)

__all__ = [
    "Mesh", "axis_sharded_leaves", "gathered_opt_state", "host_barrier",
    "host_scalar", "init_distributed", "init_from_env", "make_mesh",
    "maybe_zero_shard_state", "pad_batch_to", "process_slice",
    "shutdown_distributed", "to_host", "zero_state_shardings"]
