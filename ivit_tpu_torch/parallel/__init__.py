"""Multi-GPU serving and data-parallel QAT over ``torch.distributed``.

Counterpart of ``ivit_tpu/parallel/`` (``mesh.py``, ``tp_infer.py``):
process groups and the ``(data, model)`` mesh, data- and
tensor-parallel serving of the int8 engines, and the data-parallel QAT
step with ZeRO-1 (``data.py``; the step itself is
``train.make_train_step(..., mesh=...)``), and tensor-parallel QAT with
sequence parallelism (``tensor.py``, ZeRO-1 composing on its slices),
and GPipe over a ``(data, pipe)`` mesh (``pipeline.py``).
"""

from .data import batch_shard, data_mean, gather_train_state, shard_train_state
from .mesh import (
    Distributed,
    Mesh,
    ModelAxis,
    init_distributed,
    make_mesh,
    param_shardings,
    shard_infer,
    zero1_shardings,
)
from .pipeline import (
    Pipeline,
    from_pp_state,
    from_pp_variables,
    make_pp_mesh,
    make_pp_train_step,
    pipeline_trunk,
    pipeline_vit_forward,
    pp_gather,
    pp_rows,
    pp_shardings,
    to_pp_state,
)
from .tensor import TensorParallel, param_slices, tensor_parallel
from .tp_infer import shard_artifact, shard_infer_tp, tp_weight_shardings

__all__ = [
    "Distributed",
    "Mesh",
    "ModelAxis",
    "Pipeline",
    "TensorParallel",
    "batch_shard",
    "data_mean",
    "from_pp_state",
    "from_pp_variables",
    "gather_train_state",
    "init_distributed",
    "make_mesh",
    "make_pp_mesh",
    "make_pp_train_step",
    "param_shardings",
    "param_slices",
    "pipeline_trunk",
    "pipeline_vit_forward",
    "pp_gather",
    "pp_rows",
    "pp_shardings",
    "shard_artifact",
    "shard_infer",
    "shard_infer_tp",
    "shard_train_state",
    "tensor_parallel",
    "to_pp_state",
    "tp_weight_shardings",
    "zero1_shardings",
]
