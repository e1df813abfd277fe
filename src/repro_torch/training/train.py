"""Train-step factory of the port: loss, grads, microbatch accumulation,
clipping, update.

Port of ``repro/training/train.py``. The train state is a dict
``{"params": nn.ModuleDict (requires_grad), "opt": {"mu", "nu", "count"}
(AdamW) or {"vr", "vc", "v", "count"} (Adafactor), "step": int32 tensor}``; ``make_train_step(cfg,
tcfg)`` returns ``(state, batch) -> (state, metrics)``, which updates the
state in place and returns it. A batch is ``{"tokens", "targets"}`` (B, S)
integer tensors on the state's device (``to_device``), with ``"frames"``
(B, enc_seq, d_model) for the encdec family and ``"patches"`` (B,
num_patches, d_model) for the vlm family; for vlm the loss reads the text
positions' logits only. The moe family's loss adds ``moe_aux`` and, with
the MTP head, 0.3 times the cross entropy of ``mtp_logits`` against the
targets rolled one to the left. The entry points default to the card.

While a ``torch.profiler`` records, the step opens the ranges of
``repro_torch.ranges``: the whole step, each micro-batch's forward and
backward, and the clip with the update; ``make_train_step`` installs the
collector's range once per process.

Under a device mesh (``sharding.ctx.use_mesh``), ``place_train_state``
places the params and moments as ``DTensor``s by ``param_specs`` and
``opt_state_specs`` and ``place_batch`` the batch by ``batch_specs``; the
same step then runs SPMD, as the JAX step does under ``jit`` with those
shardings (``repro/launch/train.py:68-90``): each gradient is reduced over
the data axes to its parameter's placement, the global norm spans every
shard, and the update runs on local shards. The loss and grad norm come
back as plain tensors, the same on every rank.

As in the JAX package, ``TrainConfig.beta1`` and ``beta2`` never reach the
optimizer: only ``learning_rate`` and ``weight_decay`` are passed, so
AdamW's defaults (0.9, 0.95) always apply (``repro/training/train.py:79``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as dev
from repro_torch import ranges
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.sharding import ctx
from repro_torch.sharding import rules as R
from repro_torch.training import optimizer as O


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits: (B,S,V) fp32 over the padded vocab; targets: (B,S) int.
    The mean of logsumexp minus the target's logit. A DTensor of logits is
    read on each rank's own block (``_cross_entropy_on_shards``)."""
    if ctx.is_dtensor(logits):
        return _cross_entropy_on_shards(logits, targets)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - picked).mean()


def _cross_entropy_on_shards(logits, targets):
    """``cross_entropy`` on each rank's block of the logits, rows (batch,
    sequence) and a vocab shard, as GSPMD partitions JAX's where-over-iota
    loss: the lse is the pmax of the local maxima over the axes that shard
    the vocab plus the log of the psum of the local exponential sums; the
    picked logit is the local masked gather of the targets that fall in this
    rank's vocab range, psummed over those axes; the sum over rows is
    psummed over the axes that shard them. Nothing of the global logits'
    shape is made: the local block enters as the kernels' inputs do
    (``ops.enter_local``), so its gradient leaves as a DTensor with the
    logits' own placements. Returns the mean as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.sharding import collectives as C
    mesh = logits.device_mesh
    # a Partial is summed first
    pl = [a if isinstance(a, Shard) else Replicate() for a in logits.placements]
    vocab = [n for n, a in zip(mesh.mesh_dim_names, pl) if a == Shard(2)]
    rows = [n for n, a in zip(mesh.mesh_dim_names, pl) if a in (Shard(0), Shard(1))]
    tpl = [a if a in (Shard(0), Shard(1)) else Replicate() for a in pl]
    (x, t), _ = ops.enter_local([(logits, pl, None), (targets, tpl, None)], pl)
    x = x.float()
    m = C.pmax_over(x.detach().amax(dim=-1), mesh, vocab)
    lse = m + torch.log(C.psum_over(torch.exp(x - m[..., None]).sum(dim=-1), mesh, vocab))
    t = t.long() - ctx.local_slices(logits.shape, mesh, pl)[2].start
    inside = (t >= 0) & (t < x.shape[-1])
    picked = x.gather(-1, t.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
    picked = C.psum_over(torch.where(inside, picked, torch.zeros_like(picked)), mesh, vocab)
    loss = C.psum_over((lse - picked).sum(), mesh, rows) / (logits.shape[0] * logits.shape[1])
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim, run_check=False)


# The batch entries the modality stubs feed, by family.
MODALITY_INPUT = {"encdec": "frames", "vlm": "patches"}


def make_loss_fn(cfg, tcfg):
    def loss_fn(params, batch):
        kwargs = {}
        if cfg.family in MODALITY_INPUT:
            name = MODALITY_INPUT[cfg.family]
            kwargs[name] = batch[name]
        logits, aux = T.apply_lm(params, cfg, batch["tokens"], remat=tcfg.remat, **kwargs)
        if cfg.family == "vlm":                   # text positions only
            logits = logits[:, cfg.num_patches:, :]
        loss = cross_entropy(logits, batch["targets"]) + aux["moe_aux"]
        if "mtp_logits" in aux:                   # deepseek's MTP head
            loss = loss + 0.3 * cross_entropy(aux["mtp_logits"],
                                              torch.roll(batch["targets"], -1, dims=1))
        return loss, {"ce": loss}
    return loss_fn


def to_device(batch: Dict[str, Any], device: dev.DeviceLike = "cuda",
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """numpy or torch arrays -> tensors on ``device``: integer entries (the
    tokens and targets) as int64, float entries (frames, patches) in
    ``dtype``, the compute dtype."""
    d = dev.resolve(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device=d, dtype=dtype if t.is_floating_point() else torch.long)
    return out


def init_train_state(cfg, tcfg, seed: int = 0, *,
                     device: dev.DeviceLike = "cuda") -> Dict[str, Any]:
    params = T.init_lm(cfg, seed, device=device)
    params.requires_grad_(True)
    d = dev.resolve(device)
    return {"params": params,
            "opt": O.opt_init(tcfg.optimizer)(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=d)}


def _replace_param(params, name: str, value: torch.Tensor) -> None:
    mod_name, _, key = name.rpartition(".")
    mod = params.get_submodule(mod_name) if mod_name else params
    mod[key] = torch.nn.Parameter(value, requires_grad=True)


def place_params(params, cfg, mesh, rules, strategy: str = "baseline"):
    """``params`` (full on every rank) as DTensors placed by
    ``param_specs``, each rank keeping its block, in place; returns them."""
    named = list(params.named_parameters())
    pl = R.port_placements(named, R.param_specs(R.stacked_shapes(named), mesh, rules, cfg,
                                                strategy), mesh)
    for name, p in named:
        _replace_param(params, name, ctx.place(p.detach(), mesh, pl[name]))
    return params


def place_train_state(state: Dict[str, Any], cfg, tcfg, mesh, rules,
                      strategy: str = "baseline") -> Dict[str, Any]:
    """The params and moments of ``state`` (full on every rank) as DTensors
    placed by ``param_specs`` / ``opt_state_specs``, each rank keeping its
    block; ``count`` and ``step`` stay replicated plain tensors."""
    named = list(state["params"].named_parameters())
    shapes = R.stacked_shapes(named)
    place_params(state["params"], cfg, mesh, rules, strategy)
    opt = state["opt"]
    if tcfg.optimizer == "adamw":
        specs = R.opt_state_specs({f"{m}/{path}": shape for m in ("mu", "nu")
                                   for path, shape in shapes.items()},
                                  mesh, rules, cfg, strategy)
        for m in ("mu", "nu"):
            mpl = R.port_placements(named, specs, mesh, prefix=f"{m}/")
            opt[m] = {k: ctx.place(t, mesh, mpl[k]) for k, t in opt[m].items()}
    else:
        specs = R.opt_state_specs({f"{m}/{path}": t.shape for m in O.PATH_KEYED
                                   for path, t in opt[m].items()},
                                  mesh, rules, cfg, strategy)
        for m in O.PATH_KEYED:
            opt[m] = {path: ctx.place(t, mesh, ctx.to_placements(specs[f"{m}/{path}"], mesh))
                      for path, t in opt[m].items()}
    return state


def place_batch(batch: Dict[str, torch.Tensor], mesh, rules) -> Dict[str, Any]:
    """A batch every rank holds in full -> DTensors placed by ``batch_specs``."""
    specs = R.batch_specs(batch, mesh, rules)
    return {k: ctx.place(v, mesh, ctx.to_placements(specs[k], mesh))
            for k, v in batch.items()}


def make_train_step(cfg, tcfg):
    loss_fn = make_loss_fn(cfg, tcfg)
    update = O.opt_update(tcfg.optimizer)

    def forward(params, batch):
        with ranges.span("step.forward"):
            return loss_fn(params, batch)[0]

    def backward(loss, leaves):
        with ranges.span("step.backward"):
            return torch.autograd.grad(loss, leaves)

    def compute_grads(params, batch):
        names, leaves = zip(*params.named_parameters())
        n = tcfg.accum_steps
        if n <= 1:
            loss = forward(params, batch)
            return loss.detach(), dict(zip(names, backward(loss, leaves)))
        micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            loss = forward(params, {k: v[i] for k, v in micro.items()})
            for a, g in zip(acc, backward(loss, leaves)):
                a += g.float()
            lsum = lsum + loss.detach()
        return lsum / n, {k: a / n for k, a in zip(names, acc)}

    def train_step(state, batch):
        with ranges.span("step"):
            params = state["params"]
            if ctx.axis_ctx()[0] is None:
                loss, grads = compute_grads(params, batch)
            else:
                from torch.distributed.tensor.experimental import implicit_replication
                if tcfg.accum_steps > 1:
                    raise NotImplementedError("accum_steps > 1 under a mesh")
                with implicit_replication():
                    loss, grads = compute_grads(params, batch)
                named = dict(params.named_parameters())
                # reduce over the data axes to each parameter's own placement
                grads = {k: g.redistribute(named[k].device_mesh, named[k].placements)
                         for k, g in grads.items()}
                loss = loss.full_tensor()
            with ranges.span("step.optimizer"):
                grads, gnorm = O.clip_by_global_norm(grads, tcfg.grad_clip)
                _, state["opt"] = update(grads, state["opt"], dict(params.named_parameters()),
                                         lr=tcfg.learning_rate,
                                         weight_decay=tcfg.weight_decay)
            state["step"] = state["step"] + 1
            return state, {"loss": loss, "grad_norm": gnorm}

    ranges.install_gc_range()
    return train_step


def kernel_launches_per_step(cfg, remat: str) -> Dict[str, int]:
    """The card's launches of each kernel of ``ops.LAUNCHES`` in one train
    step of ``cfg`` (``accum_steps`` 1) under ``remat``. Under "full" and
    "dots" each layer's forward kernels run again in the recompute; the
    final norm, and the hybrid family's shared attention block, are outside
    it (as in the JAX package, ``repro/models/transformer.py:316-320``), as
    are the encdec encoder's ``enc_norm`` and the moe family's MTP head. A
    forward of n layers launches: dense and vlm flash n, rmsnorm 2n + 1;
    ssm ssd_scan n, rmsnorm 2n + 1; hybrid (n mamba layers, g shared blocks)
    ssd_scan n, flash g, rmsnorm 2n + 2g + 1; encdec (ne encoder and n
    decoder layers) flash ne + 2n, rmsnorm 2ne + 1 + 3n + 1; moe (n layers,
    ``first_k_dense`` ones included) flash n, rmsnorm r n + 1 with r 2, or
    4 under MLA (its ``q_norm`` and ``kv_norm``), and with the MTP head one
    flash and 5 rmsnorm more (``norm_h``, ``norm_e``, its block's two, the
    final norm again). Each backward kernel runs once per forward call
    outside the recompute."""
    twice = 1 if remat == "none" else 2
    n = cfg.num_layers
    ne = cfg.num_enc_layers
    g = T.hybrid_split(cfg)[0] if cfg.family == "hybrid" else 0
    r = 4 if cfg.attention == "mla" else 2
    mtp = 1 if cfg.family == "moe" and cfg.mtp_depth else 0
    dense = {"flash_attention": (n, 0), "rmsnorm": (2 * n, 1)}
    fwd = {"dense": dense, "vlm": dense,
           "ssm": {"ssd_scan": (n, 0), "rmsnorm": (2 * n, 1)},
           "hybrid": {"ssd_scan": (n, 0), "flash_attention": (0, g),
                      "rmsnorm": (2 * n, 2 * g + 1)},
           "encdec": {"flash_attention": (ne + 2 * n, 0),
                      "rmsnorm": (2 * ne + 3 * n, 2)},
           "moe": {"flash_attention": (n, mtp),
                   "rmsnorm": (r * n, 1 + 5 * mtp)}}[cfg.family]
    counts = {name: 0 for name in ops.LAUNCHES}
    for name, (in_remat, outside) in fwd.items():
        counts[name] = twice * in_remat + outside
        counts[name + "_bwd"] = in_remat + outside
    return counts


def make_eval_step(cfg, tcfg):
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, _ = loss_fn(params, batch)
        return {"loss": loss}
    return eval_step
