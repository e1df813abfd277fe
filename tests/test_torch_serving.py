"""The port's ServingEngine and serve launcher against the JAX engine on the
CPU: greedy tokens must be exactly JAX's; temperature sampling is held to
the properties tests/test_serving.py holds (its random streams differ)."""
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
from repro_torch.serving.engine import ServingEngine


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
