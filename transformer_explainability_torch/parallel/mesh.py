"""The door users take to the parallel explain paths.

Port of the routing part of ``transformer_explainability_tpu/parallel/
mesh.py: make_sharded_explain_fn``. A process group of k ranks stands in
for the JAX mesh's model axis: with k > 1 the headline method
(``transformer_attribution`` / ``grad``, variant ``ours``, α=1, heads and
MLP width divisible by k) runs the tensor-parallel program
(:func:`.tensor.make_tp_explain_fn`). The data axis (each rank its own
slice of the batch), ``init_distributed`` and ``shard_params`` are not
ported yet (ROADMAP A8, parallel paths); every other combination
raises.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.parallel.tensor import (
    make_tp_explain_fn)


def make_sharded_explain_fn(cfg: ViTConfig, group=None, device="cuda",
                            method: str = "transformer_attribution",
                            start_layer: int = 0, alpha: float = 1.0,
                            variant: str = "ours",
                            matmul_precision: str = "float32",
                            relprop_precision: Optional[str] = None,
                            attn_precision: Optional[str] = None,
                            mlp_precision: Optional[str] = None):
    """``fn(params, images, indices)`` over the ranks of ``group`` (None:
    the default process group), as JAX ``make_sharded_explain_fn`` routes a
    mesh with a model axis: the TP program when the group has more than one
    rank and the configuration is the kernel-compatible one."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_sharded_explain_fn needs an initialised "
                           "torch.distributed process group")
    k = dist.get_world_size(group)
    if (k > 1 and method in ("transformer_attribution", "grad")
            and variant == "ours" and alpha == 1.0
            and cfg.num_heads % k == 0 and cfg.mlp_dim % k == 0):
        return make_tp_explain_fn(
            cfg, group, device, method=method, start_layer=start_layer,
            alpha=alpha, variant=variant, matmul_precision=matmul_precision,
            attn_precision=attn_precision,
            relprop_precision=relprop_precision, mlp_precision=mlp_precision)
    raise NotImplementedError(
        f"only the tensor-parallel path is ported (a group of more than one "
        f"rank, the headline method, variant 'ours', alpha 1, heads and MLP "
        f"width divisible by the group); got {k} rank(s), method "
        f"{method!r}, variant {variant!r}, alpha {alpha}: the data axis and "
        f"the other routes are ROADMAP A8, parallel paths")


__all__ = ["make_sharded_explain_fn"]
