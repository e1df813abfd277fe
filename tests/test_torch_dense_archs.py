"""The registry's other dense archs (granite-3-8b, starcoder2-7b,
mistral-nemo-12b) and the paper's nanogpt-124m, on the CPU against the JAX
package, each at a reduced config that keeps what sets the arch apart.

``reduced()`` (a copy of JAX's) cuts every arch to 4 heads of 16 on at most
4 KV heads and d_model 64, which takes away starcoder2's GQA group of 9,
granite's group of 4, mistral-nemo's attention width below d_model and the
padded vocab under a tied head. ``configs.FEATURE_CUTS`` puts each back
on top of ``reduced()`` with ``.replace(...)``. Both frameworks get the same config;
weights are drawn by JAX and carried over by ``bridge.params_from_jax``,
batches and prompts come from numpy seeds, fp32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.paper_workload import BONUS_ARCHS as JBONUS
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JaxEngine
from repro.training import train as JTR
from repro_torch import bridge, configs
from repro_torch.configs import TrainConfig
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import train as TR

# fp32 on both sides, sums in another order (tests/test_torch_models.py)
TOL = 1e-4
# Decode logits against forward logits (tests/test_models.py:84)
DECODE_TOL = 2e-2
STEP_RTOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")

# arch -> fields replaced in its reduced config (the port's own table)
ARCH_CUTS = configs.FEATURE_CUTS
ARCHS = list(ARCH_CUTS)


def _jspec(aid):
    return JBONUS[aid] if aid in JBONUS else jcfg.get_arch(aid)


def _cfgs(aid):
    kw = {**ARCH_CUTS[aid], **F32}
    return (configs.reduced(configs.get_arch(aid).model).replace(**kw),
            jcfg.reduced(_jspec(aid).model).replace(**kw))


def _models(aid, seed=0):
    cfg, jc = _cfgs(aid)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _close(tx, jx, tol=TOL):
    np.testing.assert_allclose(tx.detach().float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


def _tcfgs(aid):
    """The arch's own AdamW TrainConfig (its remat), as both frameworks'."""
    kw = {k: getattr(configs.get_arch(aid).train, k) for k in (
        "optimizer", "learning_rate", "weight_decay", "grad_clip", "remat", "accum_steps")}
    return TrainConfig(**kw), JTrainConfig(**kw)


@pytest.mark.parametrize("aid", ARCHS)
def test_the_cut_keeps_the_archs_features(aid):
    cfg, _ = _cfgs(aid)
    full = configs.get_arch(aid).model
    assert cfg == configs.reduced(full).replace(**ARCH_CUTS[aid], **F32)
    assert (cfg.family, cfg.act, cfg.tie_embeddings, cfg.rope_theta) == (
        full.family, full.act, full.tie_embeddings, full.rope_theta)
    group = cfg.num_heads // cfg.num_kv_heads
    assert group == {"starcoder2-7b": 9, "granite-3-8b": 4, "mistral-nemo-12b": 2,
                     "nanogpt-124m": 1}[aid]
    assert group == full.num_heads // full.num_kv_heads or aid == "mistral-nemo-12b"
    assert (cfg.num_heads * cfg.head_dim != cfg.d_model) == (aid == "mistral-nemo-12b")
    if cfg.tie_embeddings:
        assert cfg.vocab_size % cfg.pad_vocab_multiple and full.vocab_size % full.pad_vocab_multiple
    assert configs.get_arch(aid).train.remat == ("none" if aid == "nanogpt-124m" else "full")


@pytest.mark.parametrize("aid", ARCHS)
def test_forward_logits_match_jax(aid):
    cfg, jc, jp, tp = _models(aid, 1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    assert logits.shape == (2, 12, cfg.padded_vocab)
    _close(logits, jlogits)


@pytest.mark.parametrize("aid", ARCHS)
def test_grads_match_jax_leaf_by_leaf(aid):
    """Each leaf's gradient within 1e-4 of its largest JAX value; the tied
    embedding's padded rows, which no logit of a real token reads in the
    loss but the softmax does, among them."""
    cfg, jc = _cfgs(aid)
    tcfg, jtcfg = _tcfgs(aid)
    jstate = JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(0))
    state = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    batch = next(pipeline.synthetic_batches(2, 16, cfg.vocab_size, seed=0, n=1))
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
    if cfg.tie_embeddings:
        pad = want["embed/table"][cfg.vocab_size:]
        assert pad.shape[0] == cfg.padded_vocab - cfg.vocab_size and np.abs(pad).max() > 0


@pytest.mark.parametrize("aid", ARCHS)
def test_three_adamw_steps_match_jax(aid):
    """Loss and grad norm of three whole steps (AdamW, clipping, the arch's
    remat) from one bridged state."""
    cfg, jc = _cfgs(aid)
    tcfg, jtcfg = _tcfgs(aid)
    assert tcfg.optimizer == "adamw"
    jstate = JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(0))
    state = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    jstep = jax.jit(JTR.make_train_step(jc, jtcfg))
    step = TR.make_train_step(cfg, tcfg)
    for batch in pipeline.synthetic_batches(4, 16, cfg.vocab_size, seed=0, n=3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, TR.to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
    assert int(state["step"]) == int(jstate["step"]) == 3


@pytest.mark.parametrize("aid", ARCHS)
def test_decode_matches_forward_and_jax(aid):
    """Decode logits at every position: within 2e-2 of the port's forward
    and within 1e-4 of JAX's decode."""
    cfg, jc, jp, tp = _models(aid, 3)
    B, S = 2, 10
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    full, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    caches = T.init_caches(cfg, B, S, torch.float32, device="cpu")
    jcaches = JT.init_caches(jc, B, S, jnp.float32)
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(S):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]), caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches, jnp.int32(i))
        _close(lg, jlg)
        _close(lg[:, 0], full[:, i].numpy(), DECODE_TOL)


@pytest.mark.parametrize("aid", ARCHS)
def test_greedy_tokens_equal_jax(aid):
    cfg, jc, jp, tp = _models(aid)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = JaxEngine(jc, jp, max_len=32).generate(jnp.asarray(prompts), gen_len=8)
    got = ServingEngine(cfg, tp, max_len=32, device="cpu").generate(
        torch.from_numpy(prompts), gen_len=8)
    assert got.tokens == want.tokens and len(got.tokens[0]) == 8
    assert max(max(t) for t in got.tokens) < cfg.padded_vocab


@pytest.mark.parametrize("aid,cut,want", [
    # the cuts chip_smoke.py trains at full width, and nanoGPT whole
    ("granite-3-8b", 18, {"flash_attention": 36, "flash_attention_bwd": 18,
                          "rmsnorm": 73, "rmsnorm_bwd": 37}),
    ("starcoder2-7b", 15, {"flash_attention": 30, "flash_attention_bwd": 15,
                           "rmsnorm": 61, "rmsnorm_bwd": 31}),
    ("mistral-nemo-12b", 6, {"flash_attention": 12, "flash_attention_bwd": 6,
                             "rmsnorm": 25, "rmsnorm_bwd": 13}),
    ("nanogpt-124m", 12, {"flash_attention": 12, "flash_attention_bwd": 12,
                          "rmsnorm": 25, "rmsnorm_bwd": 25})])
def test_kernel_launches_per_train_step(aid, cut, want):
    spec = configs.get_arch(aid)
    got = TR.kernel_launches_per_step(spec.model.replace(num_layers=cut), spec.train.remat)
    assert got == {**{name: 0 for name in ops.LAUNCHES}, **want}
