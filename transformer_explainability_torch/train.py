"""Training step for the ViT classifier (port of
``transformer_explainability_tpu/train.py``).

JAX's trainer is a jitted step: softmax cross-entropy over
``vit.forward`` under ``default_matmul_precision``, autodiff, then
``optax.chain(clip_by_global_norm, adamw)``. Here the forward is
:func:`..models.vit.train_forward` under autograd, the clip is optax's rule
(:func:`clip_by_global_norm`) and the update ``torch.optim.AdamW`` (β
0.9 / 0.999, ε 1e-8, decoupled weight decay, as ``optax.adamw``). The
model is the train state's parameters; the optimizer holds the rest. The
mesh-sharded step (data and tensor parallelism) is not ported (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from transformer_explainability_torch.explain.generator import (
    _check_fp32_matmul, _resolve_device)
from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.vit import (ViTConfig,
                                                         VisionTransformer)

Tensor = torch.Tensor


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded trainer (data and tensor parallelism over a "
            "mesh) is ROADMAP A8, parallel paths")


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy of integer labels (JAX ``cross_entropy``)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


@torch.no_grad()
def clip_by_global_norm(params: Iterable[Tensor], max_norm: float) -> Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: with ``norm`` the 2-norm of every gradient together, each is
    replaced by ``(g / norm) · max_norm`` where ``norm ≥ max_norm`` and
    kept otherwise (no ε added to the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``). Decided on the device, with no
    host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """AdamW behind a global-norm clip (JAX ``make_optimizer``'s
    ``optax.chain``): :meth:`init` makes the optimizer state over a model's
    parameters, :meth:`update` clips their gradients and steps it."""
    lr: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0

    def init(self, model: torch.nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=self.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, model: torch.nn.Module,
               opt_state: torch.optim.Optimizer) -> None:
        if self.max_grad_norm:
            clip_by_global_norm(model.parameters(), self.max_grad_norm)
        opt_state.step()


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """Adam with decoupled weight decay behind the clip, mirroring the
    reference's choices (``bert_pipeline.py:289``: Adam(lr); ``:397``:
    ``clip_grad_norm(max_grad_norm)``); no clip when ``max_grad_norm`` is
    0 or None."""
    return Optimizer(lr, weight_decay, max_grad_norm)


def make_train_step(cfg: ViTConfig, optimizer: Optimizer, mesh=None,
                    matmul_precision: str = "bfloat16"):
    """``step(model, opt_state, images, labels) -> (model, opt_state,
    loss)`` (JAX ``make_train_step``): the mean cross-entropy of
    :func:`..models.vit.train_forward` at ``matmul_precision`` on
    ``images (B, C, H, W)`` and integer ``labels (B,)``, its gradients by
    autograd, then ``optimizer.update``; the model and the optimizer state
    change in place. ``loss`` is the step's loss before the update, a 0-d
    tensor on the device."""
    _no_mesh(mesh)

    def step(model: VisionTransformer, opt_state: torch.optim.Optimizer,
             images, labels) -> Tuple[VisionTransformer,
                                      torch.optim.Optimizer, Tensor]:
        if model.cfg != cfg:
            raise ValueError("model config differs from the train step's")
        dtype = model.cls_token.dtype
        device = model.cls_token.device
        _check_fp32_matmul(device, dtype)
        images = torch.as_tensor(images, device=device).to(dtype)
        labels = torch.as_tensor(labels, device=device).to(torch.int64)
        opt_state.zero_grad(set_to_none=True)
        loss = cross_entropy(
            vit_mod.train_forward(model, images, matmul_precision), labels)
        loss.backward()
        optimizer.update(model, opt_state)
        return model, opt_state, loss.detach()

    return step


def init_train_state(seed: int, cfg: ViTConfig, optimizer: Optimizer,
                     device="cuda", mesh=None
                     ) -> Tuple[VisionTransformer, torch.optim.AdamW]:
    """``(model, opt_state)`` (JAX ``init_train_state``): ``init_params``
    drawn on a CPU generator seeded from ``seed`` and moved to ``device``
    (a seed is one model on every device), and the optimizer's state over
    its parameters."""
    _no_mesh(mesh)
    device = _resolve_device(device)
    params = vit_mod.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device=device)
    model = VisionTransformer(cfg, device=device)
    model.load_state_dict(params)
    return model, optimizer.init(model)


__all__ = ["cross_entropy", "clip_by_global_norm", "Optimizer",
           "make_optimizer", "make_train_step", "init_train_state"]
