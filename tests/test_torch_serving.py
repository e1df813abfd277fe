"""The port's ServingEngine and serve launcher against the JAX engine on the
CPU: greedy tokens must be exactly JAX's; temperature sampling is held to
the properties tests/test_serving.py holds and, since the random streams
differ, to JAX's draws in distribution.

The distribution bound: N draws from p over V tokens give an empirical
distribution whose total variation from p has mean at most
0.5 * sqrt(V / N) (Cauchy-Schwarz on sum_i sqrt(p_i (1 - p_i) / N)), and
one draw moves it by at most 1 / N, so it exceeds that mean by t with
probability at most exp(-2 N t^2) (McDiarmid): ``tv_bound(V, N)`` takes t
at probability 1e-6. Two frameworks' empirical distributions are held to
each other within the sum of their bounds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine, sample


def _cfgs(aid="stablelm-1.6b", **kw):
    f32 = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (reduced(get_arch(aid).model).replace(**f32),
            jreduced(jget_arch(aid).model).replace(**f32))


@pytest.mark.parametrize("aid,kw", [
    ("stablelm-1.6b", {"num_kv_heads": 4}), ("stablelm-1.6b", {"num_kv_heads": 2}),
    ("mamba2-370m", {}), ("zamba2-1.2b", {"num_layers": 5})],
    ids=["stablelm_kh4", "stablelm_kh2", "mamba2", "zamba2_leftover"])
def test_greedy_tokens_equal_jax(aid, kw):
    cfg, jc = _cfgs(aid, **kw)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.default_rng(1).integers(0, 100, (2, 6)).astype(np.int32)
    ref = JaxEngine(jc, jp, max_len=32).generate(jnp.asarray(prompts), gen_len=8)
    res = ServingEngine(cfg, tp, max_len=32, device="cpu").generate(
        torch.from_numpy(prompts), gen_len=8)
    assert res.tokens == ref.tokens
    assert len(res.tokens) == 2 and len(res.tokens[0]) == 8
    assert res.tokens_per_s > 0 and res.prefill_s > 0


def test_temperature_sampling_differs():
    cfg, _ = _cfgs()
    eng = ServingEngine(cfg, T.init_lm(cfg, 0, device="cpu"), max_len=32,
                        device="cpu")
    prompts = torch.ones((1, 4), dtype=torch.int32)
    a = eng.generate(prompts, gen_len=10, temperature=1.5, seed=1)
    b = eng.generate(prompts, gen_len=10, temperature=1.5, seed=2)
    a2 = eng.generate(prompts, gen_len=10, temperature=1.5, seed=1)
    assert a.tokens != b.tokens          # different seeds -> different samples
    assert a.tokens == a2.tokens         # one seed -> one sample stream
    g = eng.generate(prompts, gen_len=10, temperature=0.0)
    g2 = eng.generate(prompts, gen_len=10, temperature=0.0)
    assert g.tokens == g2.tokens         # greedy is deterministic


def tv_bound(V: int, N: int, delta: float = 1e-6) -> float:
    return 0.5 * math.sqrt(V / N) + math.sqrt(math.log(1 / delta) / (2 * N))


def _tv(a, b):
    return 0.5 * np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum(-1)


def _freqs(tokens, V):
    """(N, B) draws -> (B, V) frequencies."""
    return np.stack([np.bincount(col, minlength=V) for col in np.asarray(tokens).T]) / len(tokens)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_temperature_draws_follow_jax_in_distribution(temperature):
    """20,000 draws a row of seeded (4, 64) logits: JAX's engine draw
    (``categorical(fold_in(key, i), logits / T)``) and the port's
    (``sample``: multinomial of the softmax from its generator), each within
    ``tv_bound`` of ``softmax(logits / T)`` and of the other's."""
    B, V, N = 4, 64, 20_000
    logits = (2.0 * np.random.default_rng(3).standard_normal((B, V))).astype(np.float32)
    exact = _softmax(logits.astype(np.float64) / temperature)
    key = jax.random.PRNGKey(0)
    jdraw = jax.vmap(lambda i: jax.random.categorical(
        jax.random.fold_in(key, i), jnp.asarray(logits) / temperature))(jnp.arange(N))
    tdraw = sample(torch.from_numpy(logits).repeat(N, 1), temperature,
                   torch.Generator().manual_seed(0)).reshape(N, B)
    jf, tf = _freqs(jdraw, V), _freqs(tdraw.numpy(), V)
    bound = tv_bound(V, N)                            # 0.0469
    assert np.all(_tv(jf, exact) < bound), _tv(jf, exact)
    assert np.all(_tv(tf, exact) < bound), _tv(tf, exact)
    assert np.all(_tv(tf, jf) < 2 * bound), _tv(tf, jf)
    # the bound tells this temperature from the other one
    other = _softmax(logits.astype(np.float64) / (2.2 - temperature))
    assert np.all(_tv(exact, other) > 4 * bound), _tv(exact, other)
    # temperature 0 is the argmax
    assert sample(torch.from_numpy(logits), 0.0, None)[:, 0].tolist() == \
        logits.argmax(-1).tolist()


def test_generate_first_tokens_follow_jax_engine_in_distribution():
    """The first generated token of one prompt over 2,000 seeds, JAX's
    engine against the port's on the same params (reduced stablelm, vocab
    16, whose first logits spread over several tokens): each framework's
    frequencies within ``tv_bound`` of ``softmax(logits / T)`` at the
    prompt's last position, and of each other's within twice that."""
    T, N = 1.0, 2000
    cfg, jc = _cfgs(vocab_size=16)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompt = np.array([[3]], np.int32)
    jeng = JaxEngine(jc, jp, max_len=4)
    teng = ServingEngine(cfg, tp, max_len=4, device="cpu")
    jtok = [jeng.generate(jnp.asarray(prompt), gen_len=1, temperature=T, seed=s).tokens[0][0]
            for s in range(N)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # 2,000 calls of tiny ops
    try:
        ttok = [teng.generate(torch.from_numpy(prompt), gen_len=1, temperature=T,
                              seed=s).tokens[0][0] for s in range(N)]
    finally:
        torch.set_num_threads(threads)
    logits, _ = JT.apply_lm(jp, jc, jnp.asarray(prompt))
    V = cfg.padded_vocab
    exact = _softmax(np.asarray(logits[0, -1], np.float64) / T)
    assert exact.max() < 0.9 and (exact > 0.01).sum() >= 3, exact   # a spread to test
    jf, tf = _freqs(np.array(jtok)[:, None], V)[0], _freqs(np.array(ttok)[:, None], V)[0]
    bound = tv_bound(V, N)                            # 0.103
    assert _tv(jf, exact) < bound and _tv(tf, exact) < bound, (_tv(jf, exact), _tv(tf, exact))
    assert _tv(tf, jf) < 2 * bound, _tv(tf, jf)
    assert _tv(exact, np.eye(V)[exact.argmax()]) > 2 * bound   # not the greedy token alone


def test_generate_rejects_overlong_request():
    cfg, _ = _cfgs()
    eng = ServingEngine(cfg, T.init_lm(cfg, 0, device="cpu"), max_len=8,
                        device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.ones((1, 4), dtype=torch.int32), gen_len=5)


@pytest.mark.parametrize("arch", [None, "stablelm-1.6b"])
def test_serve_launcher_on_cpu(capsys, arch):
    """The default arch is the JAX launcher's, mamba2-370m."""
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                "--gen-len", "3"] + (["--arch", arch] if arch else []))
    out = capsys.readouterr().out
    assert f"arch={arch or 'mamba2-370m'}" in out and "first request tokens:" in out
