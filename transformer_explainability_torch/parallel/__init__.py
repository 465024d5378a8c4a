"""Parallel explain paths over ``torch.distributed`` (port of
``transformer_explainability_tpu/parallel``): tensor parallelism
(:mod:`.tensor`) and the routing door users take (:mod:`.mesh`)."""

from transformer_explainability_torch.parallel.mesh import (  # noqa: F401
    make_sharded_explain_fn)
from transformer_explainability_torch.parallel.tensor import (  # noqa: F401
    TPParams, make_tp_explain_fn, shard_tp_params, tp_reshuffle_params,
    tp_shard)
