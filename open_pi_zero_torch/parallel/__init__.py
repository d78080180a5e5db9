"""Multi-device inference: a (data, model) mesh of processes, the TP
sharding rules and the collectives (counterpart of the JAX package's
``parallel/``). Rank programs that ``run_ranks`` spawns live in
``parallel/ranks.py``."""

from open_pi_zero_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    get_mesh,
    make_mesh,
    run_ranks,
    set_mesh,
    shard_batch,
)
from open_pi_zero_torch.parallel.sharding import shard_params_tp, tp_param_specs

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "get_mesh",
    "make_mesh",
    "run_ranks",
    "set_mesh",
    "shard_batch",
    "shard_params_tp",
    "tp_param_specs",
]
