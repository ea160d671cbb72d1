"""Scale-out on ``torch.distributed``: the sharding rules and the
data-parallel collectives.  Counterpart of ``repro/dist``."""

from repro_torch.dist import sharding
from repro_torch.dist.sharding import (
    FSDP,
    MODEL,
    annotate,
    batch_axes,
    make_batch_shardings,
    make_param_shardings,
    replicated,
    unshard_fsdp,
    use_mesh,
)

__all__ = [
    "sharding", "FSDP", "MODEL", "annotate", "batch_axes",
    "make_batch_shardings", "make_param_shardings", "replicated",
    "unshard_fsdp", "use_mesh",
]
