"""The vlm and encdec families (paligemma-3b, whisper-large-v3, the paper's
vit-base-16), the flash kernels' prefix-LM mask, and the registry's other
dense archs (granite-3-8b, starcoder2-7b, nanogpt-124m), on the CPU against
the JAX package: reduced widths in float32, ``device="cpu"``, weights drawn
by JAX and carried over with ``bridge.params_from_jax``, other inputs from
numpy seeds. The JAX functions run as the JAX tests run them (the models
never reach a Pallas kernel; ``blockwise_attention`` is the mask's
reference)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_workload import BONUS_ARCHS as JBONUS
from repro.models.attention import blockwise_attention as jax_blockwise
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JaxEngine
from repro.training import train as JTR
from repro_torch import bridge, configs
from repro_torch.configs import TrainConfig
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.attention import blockwise_attention
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import train as TR

# fp32 on both sides, sums in another order: the model-level tolerance of
# tests/test_torch_models.py, and the JAX kernel tests' fp32 tolerance for
# the attention functions alone.
TOL = 1e-4
ATTN_TOL = 2e-5
# Decode logits against forward logits (tests/test_models.py:84).
DECODE_TOL = 2e-2
STEP_RTOL = 1e-4

FAMILY_ARCHS = ["paligemma-3b", "whisper-large-v3", "vit-base-16"]
DENSE_ARCHS = ["granite-3-8b", "starcoder2-7b", "nanogpt-124m"]
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _jspec(aid):
    return JBONUS[aid] if aid in JBONUS else jcfg.get_arch(aid)


def _cfgs(aid, **kw):
    return (configs.reduced(configs.get_arch(aid).model).replace(**F32, **kw),
            jcfg.reduced(_jspec(aid).model).replace(**F32, **kw))


def _close(tx, jx, tol=TOL):
    np.testing.assert_allclose(tx.detach().float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


def _modality(cfg, B, seed):
    """The stub frontends' inputs: (B, n, d_model) float32, or none."""
    name = TR.MODALITY_INPUT.get(cfg.family)
    if name is None:
        return {}
    n = cfg.num_patches if cfg.family == "vlm" else cfg.enc_seq
    return {name: np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)}


def _models(aid, seed=0, **kw):
    cfg, jc = _cfgs(aid, **kw)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


# ---------------------------------------------------------------------------
# configs: own copies, held equal to the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid", FAMILY_ARCHS + DENSE_ARCHS)
def test_configs_are_copies(aid):
    port, orig = configs.get_arch(aid), _jspec(aid)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(orig.model)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(orig.train)
    assert port.skips == orig.skips
    assert (dataclasses.asdict(configs.reduced(port.model))
            == dataclasses.asdict(jcfg.reduced(orig.model)))
    assert port.model.param_counts() == orig.model.param_counts()


def test_registry_matches_the_originals():
    assert set(configs.BONUS_ARCHS) == set(JBONUS)
    ported = {a for a in jcfg.ARCH_IDS
              if jcfg.get_arch(a).model.family in configs.PORTED_FAMILIES}
    assert set(configs.ARCHS) == ported
    assert set(configs.ARCH_IDS) == ported | set(JBONUS)


@pytest.mark.parametrize("aid,family,kh,prefix", [
    ("paligemma-3b", "vlm", 1, 8), ("vit-base-16", "vlm", 4, 8),
    ("whisper-large-v3", "encdec", 4, 0)])
def test_reduced_cuts_the_modalities(aid, family, kh, prefix):
    cfg = configs.reduced(configs.get_arch(aid).model)
    assert (cfg.family, cfg.num_kv_heads, cfg.num_patches) == (family, kh, prefix)
    if family == "encdec":
        assert (cfg.num_enc_layers, cfg.enc_seq) == (2, 16)


# ---------------------------------------------------------------------------
# the prefix-LM mask: forward
# ---------------------------------------------------------------------------

def _attn_arrays(seed, B, H, KH, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            [(B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D), (B, H, Sq, D)]]


def _jax_masked(q, k, v, H, KH, prefix_len):
    """JAX's blockwise attention with K/V repeated for GQA, the row indices
    as positions, 64-key blocks (the last one padded)."""
    Sq, Sk = q.shape[2], k.shape[2]
    qpos = jnp.arange(Sq, dtype=jnp.int32)
    kpos = jnp.arange(Sk, dtype=jnp.int32)
    return jax_blockwise(q, jnp.repeat(k, H // KH, axis=1), jnp.repeat(v, H // KH, axis=1),
                         qpos, kpos, prefix_len=jnp.int32(prefix_len), block=64)


MASK_CASES = [
    # B, H, KH, Sq, Sk, prefix: no prefix, one inside, one past Sk; ragged
    # Sq and Sk, GQA and MQA (paligemma's 8 heads on 1)
    (2, 4, 2, 70, 70, 0), (2, 4, 2, 70, 70, 23), (1, 8, 1, 100, 100, 37),
    (1, 4, 1, 50, 50, 80), (1, 8, 1, 100, 60, 37), (1, 4, 4, 40, 100, 64),
    (1, 4, 2, 130, 130, 128), (1, 4, 4, 212, 212, 196)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,prefix", MASK_CASES)
def test_masked_attention_matches_jax(B, H, KH, Sq, Sk, prefix):
    """``ops.flash_attention(prefix_len=)`` (the plain version on the CPU)
    and the model-level ``blockwise_attention`` against JAX's."""
    q, k, v, _ = _attn_arrays(Sq + Sk + prefix, B, H, KH, Sq, Sk, 16)
    want = _jax_masked(*(jnp.asarray(a) for a in (q, k, v)), H, KH, prefix)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(ops.flash_attention(tq, tk, tv, prefix_len=prefix), want, ATTN_TOL)
    rep = H // KH
    got = blockwise_attention(tq, tk.repeat_interleave(rep, 1), tv.repeat_interleave(rep, 1),
                              torch.arange(Sq), torch.arange(Sk), prefix, block=64)
    _close(got, want, ATTN_TOL)


def test_prefix_zero_and_past_sk_are_the_plain_masks():
    """prefix 0 is the causal mask, a prefix of Sk or more every key: the
    same bits as the causal and non-causal calls."""
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_arrays(5, 1, 4, 2, 90, 90, 16))
    assert torch.equal(ops.flash_attention(q, k, v, prefix_len=0),
                       ops.flash_attention(q, k, v, causal=True))
    for prefix in (90, 500):
        assert torch.equal(ops.flash_attention(q, k, v, prefix_len=prefix),
                           ops.flash_attention(q, k, v, causal=False))
    # without the causal flag the prefix reads nothing
    assert torch.equal(ops.flash_attention(q, k, v, causal=False, prefix_len=7),
                       ops.flash_attention(q, k, v, causal=False))


def test_mask_refuses_a_negative_prefix():
    q = torch.zeros(1, 2, 8, 16)
    for bad in (-1, 2.5):
        with pytest.raises(ValueError, match="prefix_len"):
            ops.flash_attention(q, q, q, prefix_len=bad)
        with pytest.raises(ValueError, match="prefix_len"):
            fa.plan(q, q, q, bad)


def test_masked_lse_counts_the_prefix_keys():
    """The lse the backward reads sums every valid key, the prefix's too."""
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_arrays(6, 1, 2, 2, 40, 40, 16))
    _, lse = ops.flash_attention_plain(q, k, v, prefix_len=25, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 16 ** -0.5
    mask = ref.attention_mask(40, 40, 25)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the prefix-LM mask: backward, the plain version and the kernels' tiling
# ---------------------------------------------------------------------------

def _jax_masked_vjp(arrs, H, KH, prefix):
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: _jax_masked(q, k, v, H, KH, prefix), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,prefix", MASK_CASES)
def test_masked_attention_bwd_matches_jax(B, H, KH, Sq, Sk, prefix, monkeypatch):
    """The plain backward (over several key blocks, the last ragged) and the
    autograd Function on the CPU against jax.vjp."""
    monkeypatch.setattr(ref, "ATTN_BWD_BLOCK", 48)
    arrs = _attn_arrays(Sq + Sk + prefix + 1, B, H, KH, Sq, Sk, 16)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    want = _jax_masked_vjp(arrs, H, KH, prefix)
    causal = prefix < Sk          # ops sends a prefix past Sk to the non-causal mode
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                       prefix_len=prefix if causal else 0)
    got = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      prefix_len=prefix if causal else 0)
    for w, g in zip(want, got):
        _close(g, w, ATTN_TOL)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves, prefix_len=prefix).backward(do)
    for w, t in zip(want, leaves):
        _close(t.grad, w, ATTN_TOL)


def _valid_pair(q0, q1, k0, k1, Sq, Sk, prefix):
    """Whether rows [q0, q1) and keys [k0, k1), cut to Sq and Sk, hold a
    pair the causal prefix-LM mask lets through."""
    q1, k1 = min(q1, Sq), min(k1, Sk)
    return q0 < q1 and k0 < k1 and (k0 <= q1 - 1 or k0 < prefix)


def _tiles_with_a_valid_pair(H, Sq, Sk, prefix, q_step):
    half = fa.BWD_KEYS // 2
    dkdv = sum(_valid_pair(q0, q0 + q_step, kw0, kw0 + half, Sq, Sk, prefix)
               for kw0 in range(0, -(-Sk // fa.BWD_KEYS) * fa.BWD_KEYS, half)
               for q0 in range(0, Sq, q_step)) * H
    dq = sum(_valid_pair(q0w, q0w + half, k0, k0 + fa.BWD_KEY_TILE, Sq, Sk, prefix)
             for q0w in range(0, -(-Sq // fa.BWD_Q_ROWS) * fa.BWD_Q_ROWS, half)
             for k0 in range(0, Sk, fa.BWD_KEY_TILE)) * H
    return {"dkdv": dkdv, "dq": dq}


@pytest.mark.parametrize("B,H,KH,Sq,Sk,prefix", [
    (1, 2, 1, 212, 212, 196),      # vit: q tiles inside the prefix and straddling it
    (1, 2, 2, 300, 300, 64),       # a prefix on a tile edge
    (1, 2, 2, 300, 300, 129),      # one key past a dK/dV block
    (1, 2, 2, 300, 300, 127),      # a tile's last key the first one past the prefix
    (1, 4, 1, 384, 384, 256),      # paligemma's serve shape, cut: MQA, prefix 256
    (1, 2, 2, 100, 260, 37),       # keys past every query
    (1, 2, 2, 260, 100, 70),       # rows past every key
    (1, 4, 2, 100, 100, 37)])      # the card's ragged small case
@pytest.mark.parametrize("q_step", [64, 32])                  # widths 64 and 128
def test_masked_bwd_tiling_matches_jax(B, H, KH, Sq, Sk, prefix, q_step):
    """The bf16 backward's decomposition under the prefix mask: dK/dV blocks
    from row 0 where they start inside the prefix, a warpgroup's tile
    skipped only where every pair is past both the row and the prefix, the
    mask applied only on the tiles the kernels test, dQ up to the row or
    the prefix. Against jax.vjp, and it walks exactly the tiles that hold a
    valid pair, none twice."""
    arrs = _attn_arrays(Sq + Sk + prefix + q_step, B, H, KH, Sq, Sk, 16)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = ops.flash_attention_plain(q, k, v, return_lse=True, prefix_len=prefix)
    dq, dk, dv, visits = ref.attention_bwd_tiles(
        q, k, v, o, lse, do, q_step=q_step, keys=fa.BWD_KEYS, q_rows=fa.BWD_Q_ROWS,
        key_tile=fa.BWD_KEY_TILE, prefix_len=prefix)
    for w, g in zip(_jax_masked_vjp(arrs, H, KH, prefix), (dq, dk, dv)):
        _close(g, w, ATTN_TOL)
    assert visits == _tiles_with_a_valid_pair(H, Sq, Sk, prefix, q_step)


def test_masked_bwd_tiling_prefix_zero_is_the_causal_tiling():
    arrs = _attn_arrays(9, 1, 2, 2, 200, 200, 16)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = ops.flash_attention_plain(q, k, v, return_lse=True)
    a = ref.attention_bwd_tiles(q, k, v, o, lse, do)
    b = ref.attention_bwd_tiles(q, k, v, o, lse, do, prefix_len=0)
    assert a[3] == b[3] and all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_plan_bwd_names_the_wide_head_queue_item():
    """paligemma's head dim 256 and MLA's 192/128 train: the backward plans
    both at the width-256 tile, on any device, and the forward MLA's at its
    own (192, 128) tile. Past 256 the refusal comes before any launch and
    names no queue item."""
    q = torch.zeros(1, 8, 16, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 16, 256, dtype=torch.bfloat16)
    assert fa.plan_bwd(q, k, k, 8) == ("tensor_cores", (256, 32))
    assert fa.plan(q, k, k, 8) == ("tensor_cores", (256, 256))
    mla_q = torch.zeros(1, 8, 16, 192, dtype=torch.bfloat16)
    mla_v = torch.zeros(1, 8, 16, 128, dtype=torch.bfloat16)
    assert fa.plan_bwd(mla_q, mla_q, mla_v) == ("tensor_cores", (256, 32))
    assert fa.plan(mla_q, mla_q, mla_v) == ("tensor_cores", (192, 128))
    past = torch.zeros(1, 8, 16, 288, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 256") as refused:
        fa.plan_bwd(past, past, mla_v)
    assert "queue" not in str(refused.value)


# ---------------------------------------------------------------------------
# the models: forward, gradients, steps, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid", FAMILY_ARCHS)
def test_bridge_round_trips(aid):
    cfg, jc, jp, tp = _models(aid)
    if cfg.family == "encdec":
        assert (len(tp["enc_layers"]), len(tp["dec_layers"])) == (2, 2)
        assert set(tp["dec_layers"][0]) == {"ln1", "self_attn", "ln_x", "cross_attn",
                                             "ln2", "mlp"}
    src = bridge.flatten(jax.tree.map(np.asarray, jp))
    back = bridge.flatten(bridge.params_to_numpy(tp))
    assert src.keys() == back.keys()
    for key in src:
        np.testing.assert_array_equal(back[key], src[key], key)
    mine = bridge.flatten(bridge.params_to_numpy(T.init_lm(cfg, 0, device="cpu")))
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in src.items()}


@pytest.mark.parametrize("aid", FAMILY_ARCHS)
def test_apply_lm_matches_jax(aid):
    cfg, jc, jp, tp = _models(aid, 1)
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mod = _modality(cfg, B, 2)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks),
                           **{k: torch.from_numpy(v) for k, v in mod.items()})
    jlogits, _ = jax.jit(lambda p, t, m: JT.apply_lm(p, jc, t, **m))(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in mod.items()})
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert logits.shape == (B, extra + S, cfg.padded_vocab)
    _close(logits, jlogits)


def _tcfgs(**kw):
    kw = {"optimizer": "adamw", "learning_rate": 3e-4, "weight_decay": 0.1,
          "grad_clip": 1.0, **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _bridged(cfg, jc, jtcfg, seed=0):
    jstate = JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(seed))
    return jstate, bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")


def _batches(cfg, n, batch=2, seq=16, seed=0):
    return list(launch_train.with_modality_inputs(
        cfg, pipeline.synthetic_batches(batch, seq, cfg.vocab_size, seed=seed, n=n), seed))


# paligemma reduced but with its own head dim, 256: MQA, 2 heads on 1, so
# the flash backward's width-256 path is held against jax.grad
WIDE_HEADS = dict(head_dim=256, num_heads=2)


@pytest.mark.parametrize("aid", FAMILY_ARCHS + DENSE_ARCHS)
def test_one_step_grads_match_jax_leaf_by_leaf(aid):
    """Gradients of the loss (vlm: the text positions only) from one bridged
    state, each leaf within 1e-4 of that leaf's largest JAX gradient."""
    _grads_match_jax(aid)


def test_head_dim_256_grads_match_jax_leaf_by_leaf():
    """paligemma at head dim 256 (2 layers, 2 heads on 1 KV head, 8
    patches as the prefix): its gradients leaf by leaf against jax.grad."""
    _grads_match_jax("paligemma-3b", **WIDE_HEADS)


def _grads_match_jax(aid, **kw):
    cfg, jc = _cfgs(aid, **kw)
    tcfg, jtcfg = _tcfgs()
    jstate, state = _bridged(cfg, jc, jtcfg)
    batch = _batches(cfg, 1)[0]
    jgrads = jax.grad(lambda p: JTR.make_loss_fn(jc, jtcfg)(p, batch)[0])(jstate["params"])
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    loss, _ = TR.make_loss_fn(cfg, tcfg)(params, TR.to_device(batch, "cpu"))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = bridge.flatten(jax.tree.map(np.asarray, jgrads))
    got = bridge.flatten(bridge.unflatten(
        {k: v.numpy() for k, v in bridge._stacked(grads.items()).items()}))
    assert want.keys() == got.keys()
    for key in want:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4 * scale,
                                   err_msg=key)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("aid", FAMILY_ARCHS)
def test_three_steps_match_jax(aid, remat):
    """Loss and grad norm of three whole steps (AdamW, clipping) from one
    bridged state, each batch with its seeded frames or patches."""
    _three_steps_match_jax(aid, remat)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_head_dim_256_three_steps_match_jax(remat):
    """paligemma at head dim 256: three steps against JAX's."""
    _three_steps_match_jax("paligemma-3b", remat, **WIDE_HEADS)


def _three_steps_match_jax(aid, remat, **kw):
    cfg, jc = _cfgs(aid, **kw)
    tcfg, jtcfg = _tcfgs(remat=remat)
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


@pytest.mark.parametrize("aid,remat,want", [
    ("paligemma-3b", "full", {"flash_attention": 36, "flash_attention_bwd": 18,
                              "rmsnorm": 73, "rmsnorm_bwd": 37}),
    ("vit-base-16", "none", {"flash_attention": 12, "flash_attention_bwd": 12,
                             "rmsnorm": 25, "rmsnorm_bwd": 25}),
    ("vit-base-16", "full", {"flash_attention": 24, "flash_attention_bwd": 12,
                             "rmsnorm": 49, "rmsnorm_bwd": 25}),
    # 32 encoder and 32 decoder layers: flash 32 + 64 in the bodies, rmsnorm
    # 64 + 96 in them and enc_norm and the final norm outside
    ("whisper-large-v3", "full", {"flash_attention": 192, "flash_attention_bwd": 96,
                                  "rmsnorm": 322, "rmsnorm_bwd": 162}),
    ("whisper-large-v3", "none", {"flash_attention": 96, "flash_attention_bwd": 96,
                                  "rmsnorm": 162, "rmsnorm_bwd": 162}),
    ("granite-3-8b", "full", {"flash_attention": 80, "flash_attention_bwd": 40,
                              "rmsnorm": 161, "rmsnorm_bwd": 81})])
def test_kernel_launches_per_step_at_full_width(aid, remat, want):
    got = TR.kernel_launches_per_step(configs.get_arch(aid).model, remat)
    assert got == {**{name: 0 for name in got}, **want}
    assert set(got) == set(ops.LAUNCHES)


@pytest.mark.parametrize("aid", FAMILY_ARCHS)
def test_train_step_counts_no_launch_on_the_cpu(aid):
    """The plain versions launch nothing, so the launch rule is read on the
    card (tests/test_torch_cuda.py); here a step must leave the counts."""
    cfg, _ = _cfgs(aid)
    tcfg, _ = _tcfgs(remat="full")
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    before = dict(ops.LAUNCHES)
    state, m = TR.make_train_step(cfg, tcfg)(state, TR.to_device(_batches(cfg, 1)[0], "cpu"))
    assert ops.LAUNCHES == before and np.isfinite(float(m["loss"]))


def _jax_fill_cross(jc, jp, frames):
    """The JAX cross caches, filled as tests/test_models.py:121-140 fills them."""
    from repro.models import layers as JL
    from repro.models.transformer import _dense_body
    B, Se = frames.shape[:2]
    epos = jnp.broadcast_to(jnp.arange(Se, dtype=jnp.int32)[None], (B, Se))
    he, _ = jax.lax.scan(lambda hh, lp: (_dense_body(jc, lp, hh, epos, prefix_len=jnp.int32(Se)),
                                         None), frames, jp["enc_layers"])
    he = JL.apply_rmsnorm(jp["enc_norm"], he, jc.norm_eps)
    hd, KH = jc.head_dim, jc.num_kv_heads

    def fill(lp):
        k = (he @ lp["cross_attn"]["wk"]).reshape(B, Se, KH, hd)
        v = (he @ lp["cross_attn"]["wv"]).reshape(B, Se, KH, hd)
        return {"k": k.transpose(0, 2, 1, 3), "v": v.transpose(0, 2, 1, 3)}
    return jax.vmap(fill)(jp["dec_layers"])


@pytest.mark.parametrize("kh", [4, 2])
def test_encdec_decode_matches_forward_and_jax(kh):
    """whisper reduced: decode over the cross caches filled from the encoder
    equals the port's full forward within 2e-2 and JAX's decode logits."""
    cfg, jc, jp, tp = _models("whisper-large-v3", 3, num_kv_heads=kh)
    B, S = 2, 8
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _modality(cfg, B, 4)["frames"]
    full, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks), frames=torch.from_numpy(frames))
    caches = T.fill_cross_caches(tp, cfg, T.init_caches(cfg, B, S, torch.float32,
                                                        device="cpu"),
                                 torch.from_numpy(frames))
    jcaches = JT.init_caches(jc, B, S, jnp.float32)
    jcaches["cross"] = _jax_fill_cross(jc, jp, jnp.asarray(frames))
    for layer, cache in enumerate(caches["cross"]):
        _close(cache["k"], jcaches["cross"]["k"][layer])
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(S):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]), caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches, jnp.int32(i))
        _close(lg, jlg)
        _close(lg[:, 0], full[:, i].numpy(), DECODE_TOL)


@pytest.mark.parametrize("aid", ["paligemma-3b", "whisper-large-v3"] + DENSE_ARCHS)
def test_greedy_tokens_equal_jax(aid):
    """The engines decode from the tokens alone, as the JAX engine does: no
    patches, zero cross caches."""
    cfg, jc, jp, tp = _models(aid)
    prompts = np.random.default_rng(1).integers(0, 100, (2, 6)).astype(np.int32)
    want = JaxEngine(jc, jp, max_len=32).generate(jnp.asarray(prompts), gen_len=8)
    got = ServingEngine(cfg, tp, max_len=32, device="cpu").generate(
        torch.from_numpy(prompts), gen_len=8)
    assert got.tokens == want.tokens and len(got.tokens[0]) == 8


def test_encdec_cross_caches_start_zero():
    cfg, _ = _cfgs("whisper-large-v3")
    caches = T.init_caches(cfg, 2, 10, torch.float32, device="cpu")
    assert len(caches["self"]) == len(caches["cross"]) == cfg.num_layers
    assert caches["cross"][0]["k"].shape == (2, cfg.num_kv_heads, cfg.enc_seq, cfg.head_dim)
    assert all(float(c["k"].abs().sum()) == 0 for c in caches["cross"])


# ---------------------------------------------------------------------------
# the launcher and the batch's float entries
# ---------------------------------------------------------------------------

def test_to_device_keeps_frames_and_patches_float():
    batch = {"tokens": np.zeros((2, 4), np.int32), "targets": np.ones((2, 4), np.int32),
             "frames": np.full((2, 3, 8), 0.25, np.float32)}
    out = TR.to_device(batch, "cpu", torch.bfloat16)
    assert out["tokens"].dtype == out["targets"].dtype == torch.long
    assert out["frames"].dtype == torch.bfloat16 and float(out["frames"][0, 0, 0]) == 0.25
    assert TR.to_device(batch, "cpu")["frames"].dtype == torch.float32


@pytest.mark.parametrize("aid,name,n", [("whisper-large-v3", "frames", 16),
                                        ("vit-base-16", "patches", 8),
                                        ("stablelm-1.6b", None, 0)])
def test_with_modality_inputs(aid, name, n):
    cfg = configs.reduced(configs.get_arch(aid).model)
    a, b = (_batches(cfg, 2, seed=5) for _ in range(2))
    for x, y in zip(a, b):
        extra = set(x) - {"tokens", "targets"}
        assert extra == ({name} if name else set())
        if name:
            assert x[name].shape == (2, n, cfg.d_model) and x[name].dtype == np.float32
            np.testing.assert_array_equal(x[name], y[name])      # seeded
    if name:
        assert not np.array_equal(a[0][name], a[1][name])


@pytest.mark.parametrize("aid", ["whisper-large-v3", "vit-base-16"])
def test_launch_train_runs_the_families_on_the_cpu(aid, tmp_path, capsys):
    args = ["--arch", aid, "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done at step 2" in out
