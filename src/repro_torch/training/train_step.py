"""Train-step factory (the reference's ``repro.training.train_step``):
loss and gradients by ``torch.autograd`` → optional gradient transform →
clip → AdamW, with optional micro-batch gradient accumulation.

The state is ``{"params": tree, "opt": {"m": tree, "v": tree, "step":
int32 0-d}}`` on the model's device.  A step updates the state's tensors in
place (the reference's jitted step donates them) and returns the state."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.training.optim import (adamw_init, adamw_update,
                                        clip_by_global_norm, cosine_schedule)
from repro_torch.training.tree import leaves, tree_map, unflatten_like


def init_train_state(model, generator: torch.Generator) -> Dict:
    params = model.init(generator)
    return {"params": params, "opt": adamw_init(params, model.cfg.opt_dtype)}


def build_train_step(model, *, lr_schedule: Optional[Callable] = None,
                     max_grad_norm: float = 1.0, micro_batches: int = 1,
                     grad_transform: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    micro_batches > 1: batch leaves carry a leading (micro, ...) dim; the
    gradients of the micro-batches are accumulated in f32, ``a + g /
    micro`` in order, before the optimizer update.  grad_transform: an
    optional hook on the gradient tree (e.g. the int8 compression)."""
    lr_schedule = lr_schedule or cosine_schedule

    def grads_of(params, batch):
        ps = leaves(params)
        req = [p.detach().requires_grad_() for p in ps]
        loss, metrics = model.loss(unflatten_like(params, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten_like(params, grads))

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        if micro_batches > 1:
            dev = opt["step"].device
            micro = torch.tensor(float(micro_batches), device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(micro_batches):
                li, _, gi = grads_of(params, {k: v[i] for k, v in batch.items()})
                for a, g in zip(leaves(grads), leaves(gi)):
                    a.add_(g.float() / micro)
                del gi
                loss = loss + li / micro
            metrics = {"loss": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(opt["step"])
        new_params, new_opt = adamw_update(params, grads, opt, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr,
                       step=new_opt["step"].float())
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
