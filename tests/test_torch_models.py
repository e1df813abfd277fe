"""The port's configs, layers, attention and dense model against the JAX
package on the CPU, at reduced widths in float32. Weights are drawn by JAX
and carried over with ``bridge.params_from_jax``; other inputs come from
numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge, configs
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# fp32 on both sides; the sums run in another order, nothing else differs.
TOL = 1e-4


def _cfg(**kw):
    cfg = configs.reduced(configs.get_arch("stablelm-1.6b").model).replace(
        param_dtype="float32", compute_dtype="float32", **kw)
    return cfg, jcfg.reduced(jcfg.get_arch("stablelm-1.6b").model).replace(
        param_dtype="float32", compute_dtype="float32", **kw)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(tx, jx, tol=TOL):
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("aid", ["stablelm-1.6b", "mistral-nemo-12b",
                                 "mamba2-370m", "zamba2-1.2b", "olmoe-1b-7b",
                                 "deepseek-v3-671b"])
def test_configs_are_copies(aid):
    port, ref = configs.get_arch(aid), jcfg.get_arch(aid)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    assert port.skips == ref.skips
    assert (dataclasses.asdict(configs.reduced(port.model))
            == dataclasses.asdict(jcfg.reduced(ref.model)))
    assert port.model.param_counts() == ref.model.param_counts()


def test_unported_arch_raises():
    """Every arch of the registry is ported now: an unknown arch id raises
    KeyError naming the archs, an unknown family raises."""
    with pytest.raises(KeyError, match="olmoe-1b-7b"):
        configs.get_arch("gpt-5")
    cfg = configs.get_arch("stablelm-1.6b").model.replace(family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        T.init_lm(cfg, device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        T.apply_lm(T.init_lm(configs.reduced(configs.get_arch("stablelm-1.6b").model),
                             device="cpu"), cfg, torch.zeros((1, 2), dtype=torch.long))


def test_rope_split_half():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 11, dtype=np.int32), (2, 8))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 500.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    jp = JL.init_mlp(jax.random.PRNGKey(1), 32, 48, act)
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    _close(L.apply_mlp(_t(jp), torch.from_numpy(x), act),
           JL.apply_mlp(jp, jnp.asarray(x), act), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_layer(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    y = L.apply_rmsnorm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x).to(tdt), 1e-5)
    assert y.dtype == tdt and y.shape == (2, 7, 24)
    _close(y, JL.apply_rmsnorm({"scale": jnp.asarray(scale)},
                               jnp.asarray(x).astype(dtype), 1e-5),
           1e-5 if dtype == "float32" else 2e-2)


def test_embed_and_head():
    jp = JL.init_embed(jax.random.PRNGKey(3), 40, 16)
    jh = {"w": JL.dense_init(jax.random.PRNGKey(4), 16, 40)}
    toks = np.array([[1, 5, 39], [0, 2, 2]], np.int32)
    x = np.random.default_rng(3).standard_normal((2, 3, 16)).astype(np.float32)
    _close(L.apply_embed(_t(jp), torch.from_numpy(toks)),
           JL.apply_embed(jp, jnp.asarray(toks)), 0)
    _close(L.apply_lm_head(_t(jp), torch.from_numpy(x), _t(jh)),
           JL.apply_lm_head(jp, jnp.asarray(x), jh), 1e-5)
    _close(L.apply_lm_head(_t(jp), torch.from_numpy(x)),
           JL.apply_lm_head(jp, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("kh", [4, 2])
def test_attention_full(kh):
    cfg, jc = _cfg(num_kv_heads=kh)
    jp = JA.init_attention(jax.random.PRNGKey(5), jc)
    B, S = 2, 24
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _close(A.apply_attention_full(_t(jp), cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy())),
           JA.apply_attention_full(jp, jc, jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("kh", [4, 2])
def test_attention_decode(kh):
    cfg, jc = _cfg(num_kv_heads=kh)
    jp = JA.init_attention(jax.random.PRNGKey(6), jc)
    B, S = 2, 6
    xs = np.random.default_rng(6).standard_normal((S, B, 1, cfg.d_model)).astype(np.float32)
    jcache = JA.init_kv_cache(jc, B, S + 2, jnp.float32)
    tcache = A.init_kv_cache(cfg, B, S + 2, torch.float32, device="cpu")
    for i in range(S):
        jo, jcache = JA.apply_attention_decode(jp, jc, jnp.asarray(xs[i]), jcache, i)
        to, tcache = A.apply_attention_decode(_t(jp), cfg, torch.from_numpy(xs[i]),
                                              tcache, i)
        _close(to, jo)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def _models(seed, **kw):
    cfg, jc = _cfg(**kw)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg, "cpu")


@pytest.mark.parametrize("kh", [4, 2])
def test_apply_lm_and_decode_logits(kh):
    cfg, jc, jp, tp = _models(7, num_kv_heads=kh)
    B, S = 2, 8
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.padded_vocab)
    _close(logits, jlogits)

    caches = T.init_caches(cfg, B, S, torch.float32, device="cpu")
    jcaches = JT.init_caches(jc, B, S, jnp.float32)
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(S):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]),
                                       caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches,
                               jnp.int32(i))
        _close(lg, jlg)
        _close(lg[:, 0], logits[:, i].numpy())   # decode == forward, in the port


def test_bf16_forward_close_to_jax():
    cfg, jc = _cfg()
    cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    jc = jc.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = JT.init_lm(jax.random.PRNGKey(8), jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    # bf16 rounds at other places in the two frameworks: a looser bound.
    _close(logits, jlogits, 5e-2)
