"""The port's distributed layer on gloo ranks, held to the JAX package's
sharded runs at the same meshes.

One JAX subprocess (4 fake host devices, as ``tests/distributed_worker.py``
makes 8) computes every reference and the initial states into an ``.npz``;
one launch of 4 gloo ranks then runs every port check on those inputs:

- ``apply_moe`` at (2,2) under EP (the mesh branch), ``moe_rs`` and
  ``moe_a2a`` (capacity factor 4.0) against the local path, with the grads
  of ``sum(sin(y)) + aux`` against ``jax.grad`` of JAX's sharded path;
- 3 train steps at (2,2): reduced stablelm under baseline, dp_zero1 and
  pure_fsdp, reduced olmoe (capacity factor E/k) under baseline, moe_a2a and
  moe_rs, reduced mamba2 under baseline (AdamW), stablelm under pure_fsdp
  with Adafactor, and stablelm cut to 3 heads on 1 KV head (heads the model
  axis does not divide), losses and grad norms against JAX's sharded run
  and the port's unsharded one; the loss's gradient of the logits leaves
  each rank in its own block's shape;
- greedy decode at (2,2) with the caches laid out by ``cache_specs``
  (reduced stablelm under baseline and, its positions sharded, dp_zero1;
  olmoe under dp_zero1; mamba2 under baseline), fp32 logits and tokens
  against JAX's sharded decode and the port's unsharded one;
- the int8 compressed mean at 4 ranks and its wire bytes against a plain
  fp32 reduce, and ``make_compressed_grad_fn`` against the exact mean of
  the ranks' gradients;
- the GPipe pipeline (4 stages, 8 microbatches, D 16) and its grads;
- a checkpoint saved from a (2,2) mesh restored onto (4,1).

The launcher runs ``--nproc 4 --mesh 2x2 --device cpu`` for 6 steps, then
resumes to 9. The rank launch starts once JAX has written the inputs and
runs beside the rest of the JAX run; the launcher's two runs follow the
rank launch, so that at most the JAX run and one group of 4 ranks share the
cores. Every process takes one thread for its math (``OMP_NUM_THREADS``,
XLA's single-threaded Eigen), and the checks that the test process itself
runs take one torch thread. Every launch runs in its own session, its
output in a file, under a hard limit (``LIMITS``), and is killed whole when
it overruns. Measured on 8 cores alone (the file 97 s): JAX 89 s, the rank
launch 18 s, each launcher run 8 s; beside the suite's other five workers
(``-n 6 --dist loadfile``, the file 114 s): JAX 110-119 s, the ranks 32-36
s, each launcher run 11-13 s. The limits, 360, 240 and 120 s, are 3x, 6x
and 9x those.

The file is also the two subprocesses' program: ``python
tests/test_torch_distributed.py jax OUT.npz`` and ``... torch OUT_DIR
REF.npz``.
"""
import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
# (arch, strategy, optimizer): the arch's own (AdamW) but in the last case
TRAIN_CASES = [("stablelm-1.6b", "baseline", "adamw"), ("stablelm-1.6b", "dp_zero1", "adamw"),
               ("stablelm-1.6b", "pure_fsdp", "adamw"), ("olmoe-1b-7b", "baseline", "adamw"),
               ("olmoe-1b-7b", "moe_a2a", "adamw"), ("olmoe-1b-7b", "moe_rs", "adamw"),
               ("mamba2-370m", "baseline", "adamw"),
               ("stablelm-1.6b", "pure_fsdp", "adafactor"),
               ("stablelm-3-heads", "baseline", "adamw")]
# a test arch -> (registry arch, overrides of its reduced config)
VARIANTS = {"stablelm-3-heads": ("stablelm-1.6b", {"num_heads": 3, "num_kv_heads": 1})}
# (arch, strategy, batch): dp_zero1 shards the cache's positions over
# "model" (over both axes at batch 1), baseline its KV or ssm heads
DECODE_CASES = [("stablelm-1.6b", "baseline", 2), ("stablelm-1.6b", "dp_zero1", 1),
                ("olmoe-1b-7b", "dp_zero1", 2), ("mamba2-370m", "baseline", 2)]
DEC_LEN, DEC_PROMPT = 16, 4
MOE_CASES = {"ep": ("baseline", None, (2, 16)), "rs": ("moe_rs", None, (2, 16)),
             "a2a": ("moe_a2a", 4.0, (4, 16))}
EP_RULES = {"batch": ("data",), "expert": "model"}
STEPS, BATCH, SEQ = 3, 4, 16
PIPE = dict(S=4, M=8, mb=2, D=16)
# Each launch's hard limit in seconds (measured times in the docstring)
LIMITS = {"jax": 360, "ranks": 240, "launcher": 120}


def _variant(arch):
    return VARIANTS.get(arch, (arch, {}))


def _prompt(arch, strategy, batch, vocab):
    rng = np.random.default_rng(len(arch) + len(strategy) + batch)
    return rng.integers(0, vocab, (batch, DEC_PROMPT)).astype(np.int32)


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (BATCH, SEQ + 1))
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "targets": t[:, 1:].astype(np.int32)})
    return out


# ---------------------------------------------------------------------------
# the JAX references (subprocess)
# ---------------------------------------------------------------------------

def jax_main(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={WORLD} "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    sys.path.insert(0, SRC)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_arch, reduced
    from repro.launch.mesh import make_mesh
    from repro.models import moe as M
    from repro.sharding.compat import shard_map
    from repro.sharding.ctx import use_mesh
    from repro.sharding.pipeline_parallel import pipeline_apply
    from repro.sharding.rules import (batch_specs, cache_specs, opt_state_specs,
                                      param_specs, rules_for, to_named)
    from repro.training import train as TR
    from repro.training.compression import compressed_psum_mean

    out = {}

    def put(prefix, tree):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)
            out[f"{prefix}/{key}"] = np.asarray(leaf)

    mesh22 = make_mesh((2, 2), ("data", "model"))
    key = jax.random.PRNGKey(0)
    base = reduced(get_arch("olmoe-1b-7b").model).replace(param_dtype="float32",
                                                          compute_dtype="float32")

    def train_cfgs(arch, optimizer):
        base_arch, overrides = _variant(arch)
        spec = get_arch(base_arch)
        cfg = reduced(spec.model).replace(param_dtype="float32", compute_dtype="float32",
                                          **overrides)
        if cfg.num_experts:
            cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token)
        return cfg, spec.train.__class__(optimizer=optimizer, learning_rate=1e-3,
                                         remat="none")

    # the inputs, for the port's ranks to start on while the references run
    moe_in = {}
    for name, (strategy, cf, shape) in MOE_CASES.items():
        cfg = base.replace(capacity_factor=cf) if cf else base
        moe_in[name] = (cfg, M.init_moe(key, cfg, jnp.float32),
                        jax.random.normal(jax.random.fold_in(key, 1),
                                          shape + (cfg.d_model,)))
        put(f"moe/{name}/p", moe_in[name][1])
        out[f"moe/{name}/x"] = np.asarray(moe_in[name][2])
    for arch, opt in sorted({(a, o) for a, _, o in TRAIN_CASES}):
        cfg, tcfg = train_cfgs(arch, opt)
        put(f"init/{arch}/{opt}", TR.init_train_state(cfg, tcfg, key))
    S, Mb, mb, D = PIPE["S"], PIPE["M"], PIPE["mb"], PIPE["D"]
    out["pipe/w"] = np.asarray(jax.random.normal(key, (S, D, D)) * 0.3)
    out["pipe/x"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (Mb, mb, D)))
    out["comp/g"] = np.asarray(jax.random.normal(key, (WORLD, 1000)))
    np.savez(inputs_path + ".tmp.npz", **out)
    os.rename(inputs_path + ".tmp.npz", inputs_path)

    for name, (strategy, cf, shape) in MOE_CASES.items():
        cfg, p, x = moe_in[name]

        def f(pp, xx, cfg=cfg):
            y, aux = M.apply_moe(pp, cfg, xx)
            return jnp.sum(jnp.sin(y)) + aux, y
        (_, y_local), _ = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
        with use_mesh(mesh22, EP_RULES, strategy=strategy):
            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                          has_aux=True))(p, x)
        out[f"moe/{name}/y_local"] = np.asarray(y_local)
        out[f"moe/{name}/y"] = np.asarray(y)
        put(f"moe/{name}/gp", gp)
        out[f"moe/{name}/gx"] = np.asarray(gx)

    for arch, strategy, opt in TRAIN_CASES:
        cfg, tcfg = train_cfgs(arch, opt)
        rules = rules_for(_variant(arch)[0], strategy)
        with use_mesh(mesh22, rules, strategy):
            state = TR.init_train_state(cfg, tcfg, key)
            sh = {"params": to_named(param_specs(state["params"], mesh22, rules, cfg,
                                                 strategy), mesh22),
                  "opt": to_named(opt_state_specs(state["opt"], mesh22, rules, cfg,
                                                  strategy), mesh22),
                  "step": NamedSharding(mesh22, P())}
            state = jax.device_put(state, sh)
            step = jax.jit(TR.make_train_step(cfg, tcfg), in_shardings=(sh, None),
                           out_shardings=(sh, None))
            curve = []
            for b in _batches(cfg.vocab_size):
                b = jax.device_put(b, to_named(batch_specs(b, mesh22, rules), mesh22))
                state, m = step(state, b)
                curve.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"train/{arch}/{strategy}/{opt}"] = np.asarray(curve)

    from repro.models import transformer as T
    for arch, strategy, batch in DECODE_CASES:
        cfg, tcfg = train_cfgs(arch, "adamw")
        rules = rules_for(arch, strategy)
        prompt = _prompt(arch, strategy, batch, cfg.vocab_size)
        with use_mesh(mesh22, rules, strategy):
            params = TR.init_train_state(cfg, tcfg, key)["params"]
            caches = T.init_caches(cfg, batch, DEC_LEN, jnp.float32)
            p_sh = to_named(param_specs(params, mesh22, rules, cfg, strategy), mesh22)
            c_sh = to_named(cache_specs(caches, mesh22, rules), mesh22)
            t_sh = to_named(batch_specs({"token": prompt[:, :1]}, mesh22, rules),
                            mesh22)["token"]
            step = jax.jit(lambda p, c, t, i: T.apply_lm_decode(p, cfg, t, c, i),
                           in_shardings=(p_sh, c_sh, t_sh, NamedSharding(mesh22, P())),
                           out_shardings=(None, c_sh))
            params, caches = jax.device_put(params, p_sh), jax.device_put(caches, c_sh)
            logits, tokens, tok = [], [], prompt[:, :1]
            for i in range(DEC_LEN):
                lg, caches = step(params, caches, jnp.asarray(tok), jnp.int32(i))
                logits.append(np.asarray(lg[:, -1]))
                nxt = np.asarray(jnp.argmax(lg[:, -1], axis=-1)).astype(np.int32)[:, None]
                tok = prompt[:, i + 1:i + 2] if i + 1 < DEC_PROMPT else nxt
                tokens.append(tok[:, 0])
        out[f"dec/{arch}/{strategy}/logits"] = np.stack(logits, 1)
        out[f"dec/{arch}/{strategy}/tokens"] = np.stack(tokens, 1)

    mesh4 = make_mesh((WORLD,), ("data",))
    red = shard_map(lambda gl: compressed_psum_mean(gl[0], "data")[None], mesh=mesh4,
                    in_specs=P("data"), out_specs=P("data"), check_vma=False)(
                        jnp.asarray(out["comp/g"]))
    out["comp/red"] = np.asarray(red)

    stage = make_mesh((S,), ("stage",))
    w, x = jnp.asarray(out["pipe/w"]), jnp.asarray(out["pipe/x"])
    run = pipeline_apply(lambda prm, h: jnp.tanh(h @ prm["w"]), stage,
                         num_microbatches=Mb)
    out["pipe/y"] = np.asarray(run({"w": w}, x))
    out["pipe/gw"] = np.asarray(jax.grad(lambda ww: jnp.sum(run({"w": ww}, x) ** 2))(w))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port's ranks (subprocess)
# ---------------------------------------------------------------------------

def torch_main(out_dir, ref_path):
    import torch.multiprocessing as mp
    rdzv = os.path.join(out_dir, "rdzv")
    mp.start_processes(_rank, args=(rdzv, out_dir, ref_path), nprocs=WORLD, join=True,
                       start_method="spawn")


def _subtree(ref, prefix):
    from repro_torch import bridge
    n = len(prefix) + 1
    return bridge.unflatten({k[n:]: ref[k] for k in ref.files if k.startswith(prefix + "/")})


def _rank(rank, rdzv, out_dir, ref_path):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=WORLD)
    ref = np.load(ref_path)
    res = {}
    from repro_torch.launch.mesh import make_mesh
    mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    _moe_checks(ref, mesh22, res)
    _train_checks(ref, mesh22, res)
    _logits_grad_checks(ref, mesh22, res)
    _decode_checks(ref, mesh22, res)
    _compression_checks(ref, res)
    _pipeline_checks(ref, res)
    _elastic_checks(ref, mesh22, res, out_dir)
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "port.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _moe_setup(ref, name):
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe as M
    strategy, cf, _ = MOE_CASES[name]
    cfg = reduced(get_arch("olmoe-1b-7b").model).replace(param_dtype="float32",
                                                         compute_dtype="float32")
    if cf:
        cfg = cfg.replace(capacity_factor=cf)
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    flat = {"router": "router", "experts.gate": "experts/gate",
            "experts.up": "experts/up", "experts.down": "experts/down"}
    with torch.no_grad():
        for n, t in p.named_parameters():
            t.copy_(torch.from_numpy(ref[f"moe/{name}/p/{flat[n]}"]))
    return cfg, strategy, p, torch.from_numpy(ref[f"moe/{name}/x"])


def _moe_loss(cfg, p, x):
    import torch
    from repro_torch.models import moe as M
    y, aux = M.apply_moe(p, cfg, x)
    return torch.sin(y).sum() + aux, y


def _moe_checks(ref, mesh, res):
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import param_specs, port_placements, stacked_shapes
    for name in MOE_CASES:
        cfg, strategy, p, x = _moe_setup(ref, name)
        named = list(p.named_parameters())
        with ctx.use_mesh(mesh, EP_RULES, strategy), implicit_replication():
            pl = port_placements(named, param_specs(stacked_shapes(named), mesh,
                                                    EP_RULES, cfg), mesh)
            pd = {n: ctx.place(t.detach(), mesh, pl[n], requires_grad=True) for n, t in named}
            pp = {"router": pd["router"],
                  "experts": {k: pd["experts." + k] for k in ("gate", "up", "down")}}
            xd = ctx.place(x, mesh, ctx.to_placements(("data",), mesh), requires_grad=True)
            loss, y = _moe_loss(cfg, pp, xd)
            grads = torch.autograd.grad(loss, [pd[n] for n, _ in named] + [xd])
        res[f"moe/{name}/y"] = y.full_tensor().detach()
        for (n, _), g in zip(named + [("x", None)], grads):
            res[f"moe/{name}/g/{n}"] = g.full_tensor().detach()


def _train_cfgs(arch, optimizer="adamw"):
    import dataclasses
    from repro_torch.launch.train import configs
    base_arch, overrides = _variant(arch)
    cfg, tcfg = configs(base_arch, full=False)
    cfg = cfg.replace(**overrides)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg, dataclasses.replace(tcfg, optimizer=optimizer)


def _curve(arch, opt, ref, mesh=None, rules=None, strategy="baseline"):
    """3 steps from JAX's initial state: [(loss, grad norm)]."""
    import torch
    from repro_torch import bridge
    from repro_torch.training import train as TR
    cfg, tcfg = _train_cfgs(arch, opt)
    state = bridge.state_from_jax(_subtree(ref, f"init/{arch}/{opt}"), cfg, device="cpu")
    if mesh is not None:
        state = TR.place_train_state(state, cfg, tcfg, mesh, rules, strategy)
    step = TR.make_train_step(cfg, tcfg)
    out = []
    for b in _batches(cfg.vocab_size):
        b = {k: torch.from_numpy(v).long() for k, v in b.items()}
        if mesh is not None:
            b = TR.place_batch(b, mesh, rules)
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return np.asarray(out), state


def _train_checks(ref, mesh, res):
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import rules_for
    for arch, strategy, opt in TRAIN_CASES:
        rules = rules_for(_variant(arch)[0], strategy)
        with ctx.use_mesh(mesh, rules, strategy):
            res[f"train/{arch}/{strategy}/{opt}"] = _curve(arch, opt, ref, mesh, rules,
                                                           strategy)[0]


def _logits_grad_checks(ref, mesh, res):
    """The loss's gradient of the logits on each rank: a DTensor of the
    logits' placements whose local block has the local logits' shape."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import bridge
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR
    arch = "stablelm-1.6b"
    cfg, tcfg = _train_cfgs(arch)
    rules = rules_for(arch)
    state = bridge.state_from_jax(_subtree(ref, f"init/{arch}/adamw"), cfg, device="cpu")
    state = TR.place_train_state(state, cfg, tcfg, mesh, rules)
    b = {k: torch.from_numpy(v).long() for k, v in _batches(cfg.vocab_size)[0].items()}
    b = TR.place_batch(b, mesh, rules)
    with ctx.use_mesh(mesh, rules), implicit_replication():
        logits, _ = T.apply_lm(state["params"], cfg, b["tokens"])
        (g,) = torch.autograd.grad(TR.cross_entropy(logits, b["targets"]), [logits])
    res["ce/placements"] = tuple(tuple(map(repr, t.placements)) for t in (logits, g))
    res["ce/shapes"] = (tuple(g.to_local().shape), tuple(logits.to_local().shape),
                        tuple(logits.shape))


def _decode_checks(ref, mesh, res):
    """Greedy decode from JAX's initial params, unsharded and at (2,2) with
    the caches laid out by ``cache_specs``: each step's fp32 logits, and the
    tokens fed on (the prompt's, then the greedy ones)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import bridge
    from repro_torch.launch.dryrun import place_caches
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR
    for arch, strategy, batch in DECODE_CASES:
        cfg, tcfg = _train_cfgs(arch)
        rules = rules_for(arch, strategy)
        prompt = torch.from_numpy(_prompt(arch, strategy, batch, cfg.vocab_size)).long()
        for name in ("plain", "mesh"):
            state = bridge.state_from_jax(_subtree(ref, f"init/{arch}/adamw"), cfg,
                                          device="cpu")
            caches = T.init_caches(cfg, batch, DEC_LEN, torch.float32, device="cpu")
            def use():
                return ctx.use_mesh(mesh, rules, strategy)
            if name == "mesh":
                state = TR.place_train_state(state, cfg, tcfg, mesh, rules, strategy)
                with use():
                    caches = place_caches(caches, mesh, rules)
            params = state["params"].requires_grad_(False)
            logits, tokens, tok = [], [], prompt[:, :1]
            with torch.no_grad():
                for i in range(DEC_LEN):
                    if name == "mesh":
                        with use(), implicit_replication():
                            lg, _ = T.apply_lm_decode(params, cfg, tok, caches, i)
                        lg = lg.full_tensor()
                    else:
                        lg, _ = T.apply_lm_decode(params, cfg, tok, caches, i)
                    logits.append(lg[:, -1])
                    tok = (prompt[:, i + 1:i + 2] if i + 1 < DEC_PROMPT
                           else lg[:, -1].argmax(-1, keepdim=True))
                    tokens.append(tok[:, 0])
            res[f"dec/{arch}/{strategy}/{name}"] = (torch.stack(logits, 1),
                                                     torch.stack(tokens, 1))


def _compression_checks(ref, res):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import collectives as C
    from repro_torch.training.compression import compressed_psum_mean
    mesh = make_mesh((WORLD,), ("data",), device_type="cpu")
    g = torch.from_numpy(ref["comp/g"])[dist.get_rank()]
    res["comp/red"] = compressed_psum_mean(g, mesh, "data")
    n = 1 << 16
    big = torch.randn(n, generator=torch.Generator().manual_seed(dist.get_rank()))
    C.reset_bytes()
    compressed_psum_mean(big, mesh, "data")
    res["comp/bytes_int8"] = sum(C.BYTES.values())
    C.reset_bytes()
    C.psum(big, mesh, "data")
    res["comp/bytes_fp32"] = sum(C.BYTES.values())
    # the int8 path inside a DP gradient step, against the exact mean
    from repro_torch.training.compression import make_compressed_grad_fn
    w = torch.linspace(-1, 1, 64).reshape(8, 8).requires_grad_(True)
    xs = torch.randn(WORLD, 4, 8, generator=torch.Generator().manual_seed(7))

    def loss_fn(params, x):
        return torch.tanh(x @ params["w"]).square().mean(), {}
    loss, red, err = make_compressed_grad_fn(loss_fn, mesh)(
        {"w": w}, None, xs[dist.get_rank()])
    exact = torch.stack([torch.autograd.grad(loss_fn({"w": w}, x)[0], [w])[0] for x in xs])
    res["comp/grad_rel"] = float((red["w"] - exact.mean(0)).abs().max()
                                 / exact.mean(0).abs().max())
    res["comp/loss"] = (float(loss), float(np.mean([float(loss_fn({"w": w}, x)[0])
                                                    for x in xs])))
    res["comp/err_is_residual"] = bool(torch.allclose(
        err["w"], exact[dist.get_rank()] - red["w"]))


def _pipeline_checks(ref, res):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.pipeline_parallel import pipeline_apply
    mesh = make_mesh((PIPE["S"],), ("stage",), device_type="cpu")
    w = torch.from_numpy(ref["pipe/w"])[dist.get_rank()].clone().requires_grad_(True)
    x = torch.from_numpy(ref["pipe/x"])
    run = pipeline_apply(lambda prm, h: torch.tanh(h @ prm["w"]), mesh,
                         num_microbatches=PIPE["M"])
    y = run({"w": w}, x)
    (gw,) = torch.autograd.grad((y ** 2).sum(), [w])
    gws = [torch.empty_like(gw) for _ in range(PIPE["S"])]
    dist.all_gather(gws, gw.contiguous())
    res["pipe/y"], res["pipe/gw"] = y.detach(), torch.stack(gws)


def _elastic_checks(ref, mesh22, res, out_dir):
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR
    from repro_torch.training.checkpoint import CheckpointManager
    arch = "stablelm-1.6b"
    cfg, tcfg = _train_cfgs(arch)
    rules = rules_for(arch)
    state = bridge.state_from_jax(_subtree(ref, f"init/{arch}/adamw"), cfg, device="cpu")
    state = TR.place_train_state(state, cfg, tcfg, mesh22, rules)
    flat = bridge.state_to_flat(state)
    mgr = CheckpointManager(os.path.join(out_dir, "elastic_ckpt"))
    if dist.get_rank() == 0:
        mgr.save(1, flat)
    dist.barrier()
    mesh41 = make_mesh((WORLD, 1), ("data", "model"), device_type="cpu")
    other = TR.init_train_state(cfg, tcfg, 1, device="cpu")
    other = TR.place_train_state(other, cfg, tcfg, mesh41, rules, "pure_fsdp")
    other = mgr.restore(1, like=other)
    back = bridge.state_to_flat(other)
    res["elastic/max_err"] = max(float((back[k].float() - flat[k].float()).abs().max())
                                 for k in flat)
    res["elastic/mesh"] = tuple(other["params"]["embed"]["table"].device_mesh.mesh.shape)
    res["elastic/keys"] = sorted(back) == sorted(flat)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

class _Launch:
    """A subprocess in its own session, its output in a file (a pipe that
    nobody reads would stall it), one thread for each process's math
    library, killed whole when it overruns its hard time limit, so no rank
    outlives the test."""

    def __init__(self, args, timeout, log):
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.args, self.deadline = args, time.monotonic() + timeout
        self.log = open(log, "w+")
        self.proc = subprocess.Popen(args, stdout=self.log, stderr=subprocess.STDOUT,
                                     text=True, env=env, start_new_session=True)

    def done(self) -> bool:
        return self.proc.poll() is not None

    def wait(self) -> str:
        try:
            self.proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            overran = False
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            overran = True
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        if overran:
            raise AssertionError(f"{self.args} overran its time limit:\n{out[-4000:]}")
        assert self.proc.returncode == 0, out[-6000:]
        return out


def _launcher(ck, steps):
    return _Launch([sys.executable, "-m", "repro_torch.launch.train", "--nproc", "4",
                    "--mesh", "2x2", "--device", "cpu", "--batch", "8", "--seq", "16",
                    "--ckpt-dir", ck, "--ckpt-every", "3", "--log-every", "3",
                    "--steps", str(steps)], timeout=LIMITS["launcher"],
                   log=f"{ck}_{steps}.log")


import pytest  # noqa: E402  (the subprocesses above need no pytest)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX references and the port's ranks run side by side, the ranks
    started once JAX has written the inputs; the launcher's two runs follow
    the ranks, while JAX finishes."""
    import torch
    d = tmp_path_factory.mktemp("dist")
    inputs, ref = str(d / "inputs.npz"), str(d / "ref.npz")
    ck = str(d / "ckpt")
    jax_run = _Launch([sys.executable, __file__, "jax", inputs, ref], timeout=LIMITS["jax"],
                      log=str(d / "jax.log"))
    while not os.path.exists(inputs):
        assert not jax_run.done() or os.path.exists(inputs), jax_run.wait()[-4000:]
        assert time.monotonic() < jax_run.deadline, "no inputs from the JAX run"
        time.sleep(0.2)
    ranks = _Launch([sys.executable, __file__, "torch", str(d), inputs],
                    timeout=LIMITS["ranks"], log=str(d / "ranks.log"))
    ranks.wait()
    launched = [_launcher(ck, 6).wait()]
    launched.append(_launcher(ck, 9).wait())
    jax_run.wait()
    return (np.load(ref), torch.load(str(d / "port.pt"), weights_only=False),
            launched, sorted(os.listdir(ck)))


@contextlib.contextmanager
def _one_thread():
    """torch in this process on one thread for a while: beside the launches
    and other workers, its own pool would only wait for cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_expert_parallel_moe_matches_local_and_jax_grads(results, name):
    import torch
    ref, port = results[:2]
    cfg, _, p, x = _moe_setup(ref, name)
    p.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    with _one_thread():
        _, y_local = _moe_loss(cfg, p, x)
    y = port[f"moe/{name}/y"].numpy()
    if name == "rs":                  # a bf16 round trip of the partial sums
        assert _rel(y, ref[f"moe/{name}/y"]) < 2e-2
        assert _rel(y, y_local.detach()) < 2e-2
        tol = 2e-2
    else:
        assert float(np.max(np.abs(y - ref[f"moe/{name}/y_local"]))) < 2e-4
        assert float(np.max(np.abs(y - y_local.detach().numpy()))) < 2e-4
        tol = 1e-4
    jax_names = {"router": "router", "experts.gate": "experts/gate",
                 "experts.up": "experts/up", "experts.down": "experts/down"}
    for n, j in jax_names.items():
        assert _rel(port[f"moe/{name}/g/{n}"], ref[f"moe/{name}/gp/{j}"]) < tol, n
    assert _rel(port[f"moe/{name}/g/x"], ref[f"moe/{name}/gx"]) < tol
    assert torch.isfinite(port[f"moe/{name}/g/x"]).all()


@pytest.mark.parametrize("arch,strategy,opt", TRAIN_CASES)
def test_sharded_train_steps_match_jax_and_unsharded(results, arch, strategy, opt):
    ref, port = results[:2]
    got = port[f"train/{arch}/{strategy}/{opt}"]
    want = ref[f"train/{arch}/{strategy}/{opt}"]
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want)), (got, want)
    with _one_thread():
        plain, _ = _curve(arch, opt, ref)
    # moe_rs rounds the expert outputs' partial sums to bf16
    tol = 2e-3 if strategy == "moe_rs" else 1e-5
    assert np.all(np.abs(got - plain) <= tol * np.abs(plain)), (got, plain)


def test_loss_gradient_stays_in_each_ranks_logits_block(results):
    """The loss reads each rank's block of the logits (rows over data,
    vocab over model) and its gradient leaves in the same placements, the
    local block's shape, never the global logits'."""
    port = results[1]
    placed, grad = port["ce/placements"]
    assert placed == grad and any("Shard(dim=2)" in p for p in placed), port["ce/placements"]
    local_grad, local, whole = port["ce/shapes"]
    assert local_grad == local and local != whole
    assert local[0] * 2 == whole[0] and local[2] * 2 == whole[2]


@pytest.mark.parametrize("arch,strategy,batch", DECODE_CASES)
def test_sharded_decode_matches_jax_and_unsharded(results, arch, strategy, batch):
    """Decode over caches laid out by ``cache_specs`` at (2,2), past the
    shard boundaries of the positions where they are sharded: fp32 logits
    within 1e-4 of JAX's sharded decode and of the port's unsharded one,
    greedy tokens equal."""
    ref, port = results[:2]
    want_logits = ref[f"dec/{arch}/{strategy}/logits"]
    want_tokens = ref[f"dec/{arch}/{strategy}/tokens"]
    (logits, tokens), (plain, plain_tokens) = (port[f"dec/{arch}/{strategy}/{n}"]
                                               for n in ("mesh", "plain"))
    assert logits.shape == want_logits.shape == (batch, DEC_LEN, want_logits.shape[-1])
    assert np.isfinite(logits.numpy()).all()
    assert float(np.max(np.abs(logits.numpy() - want_logits))) < 1e-4
    assert float((logits - plain).abs().max()) < 1e-4
    assert np.array_equal(tokens.numpy(), want_tokens)
    assert np.array_equal(tokens.numpy(), plain_tokens.numpy())


def test_compressed_mean_matches_jax_and_moves_fewer_bytes(results):
    ref, port = results[:2]
    assert float(np.max(np.abs(port["comp/red"].numpy() - ref["comp/red"][0]))) < 1e-6
    exact = ref["comp/g"].mean(0)
    assert _rel(port["comp/red"], exact) < 0.05
    assert port["comp/bytes_fp32"] >= 2.5 * port["comp/bytes_int8"], (
        port["comp/bytes_fp32"], port["comp/bytes_int8"])
    assert port["comp/grad_rel"] < 0.05
    assert abs(port["comp/loss"][0] - port["comp/loss"][1]) < 1e-6
    assert port["comp/err_is_residual"]


def test_pipeline_matches_jax_and_its_grad(results):
    ref, port = results[:2]
    assert float(np.max(np.abs(port["pipe/y"].numpy() - ref["pipe/y"]))) < 1e-5
    assert float(np.max(np.abs(port["pipe/gw"].numpy() - ref["pipe/gw"]))) < 1e-5
    # and the sequential stages
    y = ref["pipe/x"]
    for s in range(PIPE["S"]):
        y = np.tanh(y @ ref["pipe/w"][s])
    assert float(np.max(np.abs(port["pipe/y"].numpy() - y))) < 1e-5


def test_checkpoint_from_2x2_restores_onto_4x1(results):
    port = results[1]
    assert port["elastic/keys"] and port["elastic/mesh"] == (WORLD, 1)
    assert port["elastic/max_err"] == 0.0


def test_launcher_trains_on_a_2x2_mesh_and_resumes(results):
    first, second = results[2]
    assert "done at step 6 on mesh (2, 2)" in first
    assert "resuming from checkpoint step 6" in second
    assert "done at step 9 on mesh (2, 2)" in second
    assert "step_00000009" in results[3]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2], sys.argv[3])
    else:
        sys.path.insert(0, SRC)
        torch_main(sys.argv[2], sys.argv[3])
