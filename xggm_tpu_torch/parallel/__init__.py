"""Scale-out over `torch.distributed` (counterpart of
`xggm_tpu/parallel/`): the process group and the rank's feed
(`distributed.py`), the (data, model, pipe) grid, the tensor-parallel and
ZeRO-1 layouts (`mesh.py`), the tensor-parallel Dense (`tensor.py`) and the
GPipe pipeline, generic and of the LXMERT encoder (`pipeline.py`,
`pipeline_lxmert.py`)."""
from xggm_tpu_torch.parallel.distributed import (
    host_barrier, host_scalar, init_distributed, init_from_env,
    process_slice, shutdown_distributed, to_host)
from xggm_tpu_torch.parallel.mesh import (
    Mesh, axis_sharded_leaves, gathered_opt_state, make_mesh,
    maybe_zero_shard_state, pad_batch_to, param_shardings,
    zero_state_shardings)
from xggm_tpu_torch.parallel.pipeline import (
    NotLastStage, from_last_stage, gpipe_apply, pipeline_grads,
    sequential_apply, stack_stages, sum_over_pipe)
from xggm_tpu_torch.parallel.pipeline_lxmert import (
    clear_pipeline_mesh, get_pipeline_context, set_pipeline_mesh,
    stage_layout)
from xggm_tpu_torch.parallel.tensor import (
    ColumnParallelDense, gather_split, local_slice, shard_model_, tp_split)

__all__ = [
    "ColumnParallelDense", "Mesh", "NotLastStage", "axis_sharded_leaves",
    "clear_pipeline_mesh", "from_last_stage", "gather_split",
    "gathered_opt_state", "get_pipeline_context", "gpipe_apply",
    "host_barrier", "host_scalar", "init_distributed", "init_from_env",
    "local_slice", "make_mesh", "maybe_zero_shard_state", "pad_batch_to",
    "param_shardings", "pipeline_grads", "process_slice",
    "sequential_apply", "set_pipeline_mesh", "shard_model_",
    "shutdown_distributed", "stack_stages", "stage_layout",
    "sum_over_pipe", "to_host", "tp_split", "zero_state_shardings"]
