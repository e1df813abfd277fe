"""Train-step factory of the port: loss, grads, microbatch accumulation,
clipping, update.

Port of ``repro/training/train.py`` for the families the port runs. The
train state is a dict ``{"params": nn.ModuleDict (requires_grad), "opt":
{"mu", "nu", "count"}, "step": int32 tensor}``; ``make_train_step(cfg,
tcfg)`` returns ``(state, batch) -> (state, metrics)``, which updates the
state in place and returns it. A batch is ``{"tokens", "targets"}`` (B, S)
integer tensors on the state's device (``to_device``). The entry points
default to the card.

As in the JAX package, ``TrainConfig.beta1`` and ``beta2`` never reach the
optimizer: only ``learning_rate`` and ``weight_decay`` are passed, so
AdamW's defaults (0.9, 0.95) always apply (``repro/training/train.py:79``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as dev
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits: (B,S,V) fp32 over the padded vocab; targets: (B,S) int.
    The mean of logsumexp minus the target's logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - picked).mean()


def make_loss_fn(cfg, tcfg):
    def loss_fn(params, batch):
        logits, aux = T.apply_lm(params, cfg, batch["tokens"], remat=tcfg.remat)
        loss = cross_entropy(logits, batch["targets"]) + aux["moe_aux"]
        return loss, {"ce": loss}
    return loss_fn


def to_device(batch: Dict[str, Any], device: dev.DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """numpy or torch integer arrays -> int64 tensors on ``device``."""
    d = dev.resolve(device)
    return {k: torch.as_tensor(v).to(device=d, dtype=torch.long) for k, v in batch.items()}


def init_train_state(cfg, tcfg, seed: int = 0, *,
                     device: dev.DeviceLike = "cuda") -> Dict[str, Any]:
    params = T.init_lm(cfg, seed, device=device)
    params.requires_grad_(True)
    d = dev.resolve(device)
    return {"params": params,
            "opt": O.opt_init(tcfg.optimizer)(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=d)}


def make_train_step(cfg, tcfg):
    loss_fn = make_loss_fn(cfg, tcfg)
    update = O.opt_update(tcfg.optimizer)

    def compute_grads(params, batch):
        names, leaves = zip(*params.named_parameters())
        n = tcfg.accum_steps
        if n <= 1:
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))
        micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            loss, _ = loss_fn(params, {k: v[i] for k, v in micro.items()})
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a += g.float()
            lsum = lsum + loss.detach()
        return lsum / n, {k: a / n for k, a in zip(names, acc)}

    def train_step(state, batch):
        params = state["params"]
        loss, grads = compute_grads(params, batch)
        grads, gnorm = O.clip_by_global_norm(grads, tcfg.grad_clip)
        _, state["opt"] = update(grads, state["opt"], dict(params.named_parameters()),
                                 lr=tcfg.learning_rate,
                                 weight_decay=tcfg.weight_decay)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg, tcfg):
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, _ = loss_fn(params, batch)
        return {"loss": loss}
    return eval_step
