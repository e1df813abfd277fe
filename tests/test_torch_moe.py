"""The moe family (olmoe-1b-7b, deepseek-v3-671b: the router, the capacity
buckets, MLA, the shared expert, the first_k_dense layers, the MTP head)
and Adafactor, on the CPU against the JAX package: reduced widths in
float32, ``device="cpu"``, weights drawn by JAX and carried over with
``bridge.params_from_jax``, other inputs from numpy seeds. The JAX models
never reach a Pallas kernel; the port's kernels run as their plain versions
(the flash and rmsnorm autograd Functions with the plain forward and
backward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.attention import blockwise_attention as jax_blockwise
from repro.serving.engine import ServingEngine as JaxEngine
from repro.training import optimizer as JO
from repro.training import train as JTR
from repro_torch import bridge, configs
from repro_torch.configs import TrainConfig
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import optimizer as O
from repro_torch.training import train as TR
from repro_torch.training.checkpoint import CheckpointManager

# fp32 on both sides, sums in another order: the model-level tolerance of
# tests/test_torch_models.py, the JAX kernel tests' fp32 tolerance for the
# attention functions alone, tests/test_models.py:84's for decode against
# forward, and a relative 1e-4 for losses and grad norms after whole steps.
TOL = 1e-4
ATTN_TOL = 2e-5
DECODE_TOL = 2e-2
STEP_RTOL = 1e-4

MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfgs(aid, **kw):
    return (configs.reduced(configs.get_arch(aid).model).replace(**F32, **kw),
            jcfg.reduced(jcfg.get_arch(aid).model).replace(**F32, **kw))


def _close(tx, jx, tol=TOL):
    np.testing.assert_allclose(tx.detach().float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


def _t(tree):
    """A JAX parameter dict -> the same dict of torch tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _models(aid, seed=0, **kw):
    cfg, jc = _cfgs(aid, **kw)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the router, the capacity, the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid,router", [("olmoe-1b-7b", "softmax"),
                                        ("deepseek-v3-671b", "sigmoid")])
def test_route_matches_jax(aid, router):
    cfg, jc = _cfgs(aid)
    assert cfg.router_type == router
    jp = JM.init_moe(jax.random.PRNGKey(0), jc)
    x = _x((2, 9, cfg.d_model), 1)
    w, idx, aux = M._route(_t(jp), cfg, torch.from_numpy(x))
    jw, jidx, jaux = JM._route(jp, jc, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(aux, jaux, 1e-6)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32


def test_route_casts_the_weights_to_the_input_type():
    cfg, jc = _cfgs("deepseek-v3-671b")
    jp = JM.init_moe(jax.random.PRNGKey(0), jc)
    x = torch.from_numpy(_x((1, 4, cfg.d_model), 2)).bfloat16()
    w, _, aux = M._route(_t(jp), cfg, x)
    assert w.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("tokens,k,E,cf", [
    (1, 2, 8, 1.25), (4, 8, 64, 1.25), (512, 8, 256, 1.25), (8192, 8, 64, 1.25),
    (24, 2, 8, 4.0), (100, 3, 7, 0.5)])
def test_capacity_matches_jax(tokens, k, E, cf):
    assert M._capacity(tokens, k, E, cf) == JM._capacity(tokens, k, E, cf)
    assert M._capacity(tokens, k, E, cf) % 8 == 0


def _dropped_pairs(idx, e_local, cap):
    """The reference's overflow in numpy: pairs in (token, choice) order,
    stably by expert; a pair past its expert's first ``cap`` is dropped."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    seen, dropped = {}, set()
    for j in order:
        e = int(flat[j])
        seen[e] = seen.get(e, 0) + 1
        if seen[e] > cap:
            dropped.add(int(j))
    return dropped


def test_expert_compute_local_drops_the_same_tokens_as_jax():
    """A capacity of 8 slots for 24 tokens x 2 choices over 4 experts drops
    pairs; the port drops the pairs JAX drops, in the same order, and its
    output and gradients equal JAX's."""
    rng = np.random.default_rng(3)
    T_, k, E, D, Fd, cap = 24, 2, 4, 16, 8, 8
    x = rng.standard_normal((T_, D)).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T_)]).astype(np.int32)
    w = rng.random((T_, k)).astype(np.float32)
    gate, up = (rng.standard_normal((E, D, Fd)).astype(np.float32) * 0.3 for _ in range(2))
    down = rng.standard_normal((E, Fd, D)).astype(np.float32) * 0.3
    dropped = _dropped_pairs(idx, E, cap)
    assert len(dropped) > 0

    _, inv = M.dispatch_maps(torch.from_numpy(idx), 0, E, cap)
    assert set(np.flatnonzero(inv.numpy().reshape(-1) == E * cap)) == dropped

    def jf(x, w, g, u, d):
        return JM._expert_compute_local(x, jnp.asarray(idx), w, g, u, d, 0, E, cap)

    args = [x, w, gate, up, down]
    jy = jf(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = M._expert_compute_local(targs[0], torch.from_numpy(idx), targs[1], *targs[2:],
                                0, E, cap)
    _close(y, jy, ATTN_TOL)
    # a dropped pair contributes nothing: its token's row sums its kept pairs only
    tok = sorted(dropped)[0] // k
    assert np.abs(np.asarray(jy)[tok]).sum() > 0
    dy = rng.standard_normal((T_, D)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) * dy), argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), targs)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, ATTN_TOL)


def test_expert_compute_local_takes_a_slice_of_experts():
    """e0 / e_local: pairs of other experts are out of range, as on one EP
    shard of the reference."""
    rng = np.random.default_rng(4)
    T_, k, D, Fd = 10, 2, 8, 4
    x = rng.standard_normal((T_, D)).astype(np.float32)
    idx = rng.integers(0, 8, (T_, k)).astype(np.int32)
    w = rng.random((T_, k)).astype(np.float32)
    g, u = (rng.standard_normal((4, D, Fd)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal((4, Fd, D)).astype(np.float32)
    jy = JM._expert_compute_local(*map(jnp.asarray, (x, idx, w, g, u, d)), 4, 4, 8)
    y = M._expert_compute_local(*map(torch.from_numpy, (x, idx.astype(np.int64), w, g, u, d)),
                                4, 4, 8)
    _close(y, jy, ATTN_TOL)


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_apply_moe_matches_jax(aid):
    """olmoe (softmax, no shared expert) and deepseek (sigmoid, one shared
    expert): output, aux loss and the gradients of x and every leaf."""
    cfg, jc = _cfgs(aid)
    jp = JM.init_moe(jax.random.PRNGKey(2), jc)
    assert ("shared" in jp) == (aid == "deepseek-v3-671b")
    x = _x((2, 12, cfg.d_model), 5)
    dy = _x((2, 12, cfg.d_model), 6)

    def jloss(p, x):
        y, aux = JM.apply_moe(p, jc, x)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = bridge._module(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp))
    tp.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.apply_moe(tp, cfg, tx)
    _close(y, jy)
    _close(aux, jaux, 1e-6)
    names, leaves = zip(*tp.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux, (tx,) + leaves)
    _close(grads[0], jgx)
    want = bridge.flatten(jax.tree.map(np.asarray, jgp))
    for name, g in zip(names, grads[1:]):
        key = name.replace(".", "/")
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=TOL * float(np.abs(want[key]).max()), err_msg=key)


def test_decode_and_prefill_capacities_differ_as_in_jax():
    """The capacity comes from the call's own token count."""
    cfg, _ = _cfgs("olmoe-1b-7b")
    k, E, cf = cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor
    assert M._capacity(2, k, E, cf) == 8 != M._capacity(2 * 64, k, E, cf) == 48


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla(seed=0):
    cfg, jc = _cfgs("deepseek-v3-671b")
    jp = JA.init_mla(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge._module(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                                    jp))


def test_flash_scale_is_the_mla_scale():
    """The reference passes MLA's scale (nope + rope)^-0.5 explicitly; the
    kernel's contract scales by q's head dim^-0.5, which is the same at
    D = nope + rope (24 here, 192 at full width) with Dv = v_head_dim."""
    cfg, _ = _cfgs("deepseek-v3-671b")
    D, Dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    q, k = _x((2, 4, 20, D), 7), _x((2, 4, 20, D), 8)
    v = _x((2, 4, 20, Dv), 9)
    pos = jnp.arange(20, dtype=jnp.int32)
    want = jax_blockwise(*map(jnp.asarray, (q, k, v)), pos, pos,
                         scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    _close(got, want, ATTN_TOL)


def test_apply_mla_full_matches_jax():
    cfg, jc, jp, tp = _mla()
    x = _x((2, 11, cfg.d_model), 10)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want = JA.apply_mla_full(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = A.apply_mla_full(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, ATTN_TOL)


def test_apply_mla_decode_matches_jax_and_the_full_path():
    """The absorbed decode, token by token over its latent cache: equal to
    JAX's decode, and to the full path within the decode tolerance."""
    cfg, jc, jp, tp = _mla(1)
    B, S = 2, 7
    x = _x((B, S, cfg.d_model), 11)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    full = A.apply_mla_full(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    cache = A.init_mla_cache(cfg, B, S + 2, torch.float32, device="cpu")
    jcache = JA.init_mla_cache(jc, B, S + 2, jnp.float32)
    assert cache["c_kv"].shape == (B, S + 2, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (B, S + 2, cfg.qk_rope_dim)
    for i in range(S):
        out, cache = A.apply_mla_decode(tp, cfg, torch.from_numpy(x[:, i:i + 1]), cache, i)
        jout, jcache = JA.apply_mla_decode(jp, jc, jnp.asarray(x[:, i:i + 1]), jcache, i)
        _close(out, jout, ATTN_TOL)
        _close(out[:, 0], full[:, i].detach().numpy(), DECODE_TOL)
    _close(cache["c_kv"], jcache["c_kv"], ATTN_TOL)
    _close(cache["k_rope"], jcache["k_rope"], ATTN_TOL)


# ---------------------------------------------------------------------------
# the models: forward, bridge, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_bridge_round_trips(aid):
    cfg, jc, jp, tp = _models(aid)
    if aid == "deepseek-v3-671b":
        assert (len(tp["dense_layers"]), len(tp["layers"])) == (1, 1)
        assert set(tp["mtp"]) == {"proj", "norm_h", "norm_e", "block"}
        assert tuple(tp["layers"][0]["moe"]["experts"]["gate"].shape) == (
            cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    src = bridge.flatten(jax.tree.map(np.asarray, jp))
    back = bridge.flatten(bridge.params_to_numpy(tp))
    assert src.keys() == back.keys()
    for key in src:
        np.testing.assert_array_equal(back[key], src[key], key)
    mine = bridge.flatten(bridge.params_to_numpy(T.init_lm(cfg, 0, device="cpu")))
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in src.items()}


def test_router_stays_fp32_under_a_bf16_param_type():
    cfg, jc, jp, _ = _models("olmoe-1b-7b")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.bfloat16)
    assert tp["layers"][0]["moe"]["router"].dtype == torch.float32
    assert tp["layers"][0]["moe"]["experts"]["gate"].dtype == torch.bfloat16
    mine = T.init_lm(cfg.replace(param_dtype="bfloat16"), 0, device="cpu")
    assert mine["layers"][0]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_apply_lm_matches_jax(aid):
    """Logits, moe_aux and (deepseek) mtp_logits."""
    cfg, jc, jp, tp = _models(aid, 1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits, aux = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, jaux = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    assert logits.shape == (2, 12, cfg.padded_vocab)
    _close(logits, jlogits)
    _close(aux["moe_aux"], jaux["moe_aux"], 1e-6)
    assert float(aux["moe_aux"]) > 0
    assert set(aux) == set(jaux) == ({"moe_aux", "mtp_logits"} if cfg.mtp_depth
                                     else {"moe_aux"})
    if cfg.mtp_depth:
        _close(aux["mtp_logits"], jaux["mtp_logits"])


def test_mtp_runs_only_where_the_params_have_it():
    cfg, _, _, tp = _models("deepseek-v3-671b")
    toks = torch.randint(0, cfg.vocab_size, (1, 6), generator=torch.Generator().manual_seed(0))
    del tp["mtp"]
    _, aux = T.apply_lm(tp, cfg, toks)
    assert set(aux) == {"moe_aux"}
    assert "mtp" not in T.init_lm(cfg.replace(mtp_depth=0), 0, device="cpu")


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_decode_matches_forward_and_jax(aid):
    """Decode token by token against JAX's decode, and against the full
    forward within 2e-2 with ``capacity_factor`` E / k (the one changed
    field), so that neither path drops a token."""
    cfg, jc = _cfgs(aid)
    cf = cfg.num_experts / cfg.experts_per_token
    cfg, jc = cfg.replace(capacity_factor=cf), jc.replace(capacity_factor=cf)
    jp = JT.init_lm(jax.random.PRNGKey(3), jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    B, S = 2, 8
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    full, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    caches = T.init_caches(cfg, B, S, torch.float32, device="cpu")
    jcaches = JT.init_caches(jc, B, S, jnp.float32)
    assert len(caches["layers"]) == cfg.num_layers - cfg.first_k_dense
    assert len(caches.get("dense_layers", ())) == cfg.first_k_dense
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(S):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]), caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches, jnp.int32(i))
        _close(lg, jlg)
        _close(lg[:, 0], full[:, i].numpy(), DECODE_TOL)


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_greedy_tokens_equal_jax(aid):
    cfg, jc, jp, tp = _models(aid)
    prompts = np.random.default_rng(1).integers(0, 100, (2, 6)).astype(np.int32)
    want = JaxEngine(jc, jp, max_len=32).generate(jnp.asarray(prompts), gen_len=8)
    got = ServingEngine(cfg, tp, max_len=32, device="cpu").generate(
        torch.from_numpy(prompts), gen_len=8)
    assert got.tokens == want.tokens and len(got.tokens[0]) == 8


# ---------------------------------------------------------------------------
# training: grads, Adafactor, whole steps, launches
# ---------------------------------------------------------------------------

def _tcfgs(aid, **kw):
    kw = {"optimizer": configs.get_arch(aid).train.optimizer, "learning_rate": 3e-4,
          "weight_decay": 0.1, "grad_clip": 1.0, **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _bridged(cfg, jc, jtcfg, seed=0):
    jstate = JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(seed))
    return jstate, bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")


def _batches(cfg, n, batch=2, seq=16, seed=0):
    return list(pipeline.synthetic_batches(batch, seq, cfg.vocab_size, seed=seed, n=n))


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_one_step_grads_match_jax_leaf_by_leaf(aid):
    """Gradients of the loss (cross entropy, moe_aux and, for deepseek, the
    0.3-weighted MTP term) from one bridged state, each leaf within 1e-4 of
    that leaf's largest JAX gradient."""
    cfg, jc = _cfgs(aid)
    tcfg, jtcfg = _tcfgs(aid)
    jstate, state = _bridged(cfg, jc, jtcfg)
    batch = _batches(cfg, 1)[0]
    jloss, jgrads = jax.value_and_grad(lambda p: JTR.make_loss_fn(jc, jtcfg)(p, batch)[0])(
        jstate["params"])
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    loss, _ = TR.make_loss_fn(cfg, tcfg)(params, TR.to_device(batch, "cpu"))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_RTOL)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = bridge.flatten(jax.tree.map(np.asarray, jgrads))
    got = bridge.flatten(bridge.unflatten(
        {k: v.numpy() for k, v in bridge._stacked(grads.items()).items()}))
    assert want.keys() == got.keys()
    for key in want:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4 * scale,
                                   err_msg=key)


def _stacked_tree(rng, dtype):
    """A JAX-layout tree with stacked layers (factored and unfactored
    leaves, a (1, D) stack) and the same leaves under the port's names."""
    jtree = {"layers": {"w": rng.standard_normal((3, 5, 4)), "s": rng.standard_normal((3, 4))},
             "dense": {"s": rng.standard_normal((1, 6))},
             "b": rng.standard_normal((7,)), "m": rng.standard_normal((6, 2))}
    jtree = jax.tree.map(lambda a: a.astype(np.float32), jtree)
    port = {}
    for path, a in bridge.flatten(jtree).items():
        top, rest = path.split("/")[0], path.split("/")[1:]
        if top in ("layers", "dense"):
            for i in range(a.shape[0]):
                port[".".join([top, str(i)] + rest)] = torch.from_numpy(a[i].copy()).to(dtype)
        else:
            port[path.replace("/", ".")] = torch.from_numpy(a.copy()).to(dtype)
    return jtree, port


@pytest.mark.parametrize("dtype,wd", [("float32", 0.0), ("float32", 0.1), ("bfloat16", 0.1)])
def test_adafactor_update_matches_jax(dtype, wd):
    """From identical gradients and moments after some steps (count 3), on
    factored leaves (the stacked norm scales too, as JAX sees them) and
    unfactored ones: new params, vr, vc, v and count."""
    rng = np.random.default_rng(5)
    jtree, port = _stacked_tree(rng, getattr(torch, dtype))
    jgrads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jtree)
    jst = JO.adafactor_init(jax.tree.map(jnp.asarray, jtree))
    jst = {m: jax.tree.map(lambda a: jnp.asarray(0.1 * np.abs(rng.standard_normal(a.shape)),
                                                 jnp.float32), jst[m])
           for m in ("vr", "vc", "v")} | {"count": jnp.asarray(3, jnp.int32)}
    st = O.adafactor_init(port)
    for m in ("vr", "vc", "v"):
        flat = bridge.flatten(jax.tree.map(np.asarray, jst[m]))
        assert flat.keys() == st[m].keys()
        for k in flat:
            assert tuple(st[m][k].shape) == flat[k].shape and st[m][k].dtype == torch.float32
            st[m][k] = torch.from_numpy(flat[k].copy())
    st["count"] = torch.tensor(3, dtype=torch.int32)
    jdt = getattr(jnp, dtype)
    jnew, jopt = JO.adafactor_update(jax.tree.map(jnp.asarray, jgrads), jst,
                                     jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), jtree),
                                     lr=1e-2, weight_decay=wd)
    grads = {}
    for path, a in bridge.flatten(jgrads).items():
        top, rest = path.split("/")[0], path.split("/")[1:]
        if top in ("layers", "dense"):
            for i in range(a.shape[0]):
                grads[".".join([top, str(i)] + rest)] = torch.from_numpy(a[i].copy())
        else:
            grads[path.replace("/", ".")] = torch.from_numpy(a.copy())
    new, opt = O.adafactor_update(grads, st, port, lr=1e-2, weight_decay=wd)
    assert new is port and int(opt["count"]) == int(jopt["count"]) == 4
    got = bridge.flatten(bridge.unflatten({k: v.float().numpy() for k, v in
                                           bridge._stacked(port.items()).items()}))
    want = bridge.flatten(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jnew))
    tol = 1e-6 if dtype == "float32" else 1e-2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)
    for m in ("vr", "vc", "v"):
        jm = bridge.flatten(jax.tree.map(np.asarray, jopt[m]))
        for k in jm:
            np.testing.assert_allclose(opt[m][k].numpy(), jm[k], rtol=1e-6, atol=1e-30,
                                       err_msg=f"{m}/{k}")


def test_adafactor_state_shapes_follow_the_jax_leaves():
    cfg, jc = _cfgs("deepseek-v3-671b")
    tcfg, jtcfg = _tcfgs("deepseek-v3-671b")
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    jstate = jax.eval_shape(lambda: JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(0)))
    for m in ("vr", "vc", "v"):
        want = {k: v.shape for k, v in bridge.flatten(jstate["opt"][m]).items()}
        assert {k: tuple(v.shape) for k, v in state["opt"][m].items()} == want


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_three_steps_match_jax(aid, remat):
    """Loss and grad norm of three whole steps from one bridged state:
    olmoe with AdamW, deepseek with Adafactor (their own optimizers)."""
    cfg, jc = _cfgs(aid)
    tcfg, jtcfg = _tcfgs(aid, remat=remat)
    jstate, state = _bridged(cfg, jc, jtcfg)
    jstep = jax.jit(JTR.make_train_step(jc, jtcfg))
    step = TR.make_train_step(cfg, tcfg)
    for batch in _batches(cfg, 3, batch=4):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, TR.to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
    assert int(state["step"]) == int(jstate["step"]) == 3


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_bridged_state_round_trips(aid):
    cfg, jc = _cfgs(aid)
    _, jtcfg = _tcfgs(aid)
    jstate, state = _bridged(cfg, jc, jtcfg)
    assert set(state["opt"]) == ({"vr", "vc", "v", "count"} if aid == "deepseek-v3-671b"
                                 else {"mu", "nu", "count"})
    src = bridge.flatten(jax.tree.map(np.asarray, jstate))
    back = bridge.flatten(bridge.state_to_numpy(state))
    assert src.keys() == back.keys()
    for k in src:
        np.testing.assert_array_equal(back[k], src[k], k)


def test_adafactor_checkpoint_restores_every_moment(tmp_path):
    cfg, _ = _cfgs("deepseek-v3-671b")
    tcfg, _ = _tcfgs("deepseek-v3-671b")
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    state, _ = TR.make_train_step(cfg, tcfg)(state, TR.to_device(_batches(cfg, 1)[0], "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    fresh = mgr.restore(like=TR.init_train_state(cfg, tcfg, 7, device="cpu"))
    a, b = bridge.state_to_flat(state), bridge.state_to_flat(fresh)
    assert a.keys() == b.keys() and any(k.startswith("opt/vr/") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("aid,remat,want", [
    # 16 GQA layers: flash n, rmsnorm 2n + 1
    ("olmoe-1b-7b", "full", {"flash_attention": 32, "flash_attention_bwd": 16,
                             "rmsnorm": 65, "rmsnorm_bwd": 33}),
    ("olmoe-1b-7b", "none", {"flash_attention": 16, "flash_attention_bwd": 16,
                             "rmsnorm": 33, "rmsnorm_bwd": 33}),
    # 61 MLA layers (3 dense): flash n + the MTP block; rmsnorm 4n (ln1, ln2,
    # q_norm, kv_norm) + the final norm + 5 in the MTP head
    ("deepseek-v3-671b", "full", {"flash_attention": 123, "flash_attention_bwd": 62,
                                  "rmsnorm": 494, "rmsnorm_bwd": 250}),
    ("deepseek-v3-671b", "none", {"flash_attention": 62, "flash_attention_bwd": 62,
                                  "rmsnorm": 250, "rmsnorm_bwd": 250})])
def test_kernel_launches_per_step_at_full_width(aid, remat, want):
    got = TR.kernel_launches_per_step(configs.get_arch(aid).model, remat)
    assert got == {**{name: 0 for name in got}, **want}
    assert set(got) == set(ops.LAUNCHES)


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_train_step_counts_no_launch_on_the_cpu(aid):
    cfg, _ = _cfgs(aid)
    tcfg, _ = _tcfgs(aid, remat="full")
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    before = dict(ops.LAUNCHES)
    state, m = TR.make_train_step(cfg, tcfg)(state, TR.to_device(_batches(cfg, 1)[0], "cpu"))
    assert ops.LAUNCHES == before and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_a_train_step_gives_equal_bits_twice(aid):
    """The dispatch has no accumulating scatter: two steps from one state
    give equal params."""
    cfg, _ = _cfgs(aid)
    tcfg, _ = _tcfgs(aid)
    batch = TR.to_device(_batches(cfg, 1)[0], "cpu")
    outs = []
    for _ in range(2):
        state = TR.init_train_state(cfg, tcfg, 4, device="cpu")
        state, m = TR.make_train_step(cfg, tcfg)(state, batch)
        outs.append((float(m["loss"]), [p.detach().clone() for p in
                                         state["params"].parameters()]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_launch_train_runs_deepseek_with_adafactor_and_resumes(tmp_path, capsys):
    """The reduced deepseek through the launcher: Adafactor steps, their
    checkpoints (vr, vc, v by JAX path) and a resume."""
    from repro_torch.launch import train as launch_train
    args = ["--arch", "deepseek-v3-671b", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done at step 2" in out
    launch_train.main(args[:3] + ["3"] + args[4:])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out and "done at step 3" in out
    cfg, tcfg = launch_train.configs("deepseek-v3-671b", full=True)
    assert (cfg.num_layers, tcfg.optimizer, tcfg.remat) == (61, "adafactor", "full")


@pytest.mark.parametrize("aid", MOE_ARCHS)
def test_launch_serve_runs_the_moe_archs_on_the_cpu(aid, capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", aid, "--batch", "2", "--prompt-len", "4",
                       "--gen-len", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={aid}" in out and "first request tokens" in out
