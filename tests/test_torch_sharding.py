"""The port's sharding rules against the JAX package's, entry by entry.

Every registry arch at its full widths (JAX's trees by ``jax.eval_shape``,
the port's under ``FakeTensorMode``, shapes without storage), each of the
five strategies, on the (2,4), (16,16) and (2,16,16) meshes given as shape
stand-ins, as ``tests/test_sharding.py`` gives them: ``param_specs``,
``opt_state_specs``, ``cache_specs`` and ``batch_specs`` (so
``logical_to_spec`` under each) must give JAX's ``PartitionSpec`` entries
for every leaf, keyed by JAX path.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS, get_arch as jget_arch
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro.training import train as JTR
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R
from repro_torch.training import train as TR

STRATEGIES = ("baseline", "dp_zero1", "pure_fsdp", "moe_a2a", "moe_rs")
MESHES = {"2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_BATCH, CACHE_LEN = 128, 32_768          # decode_32k
BATCH, SEQ = 256, 4096                         # train_4k


class FakeMesh(SimpleNamespace):
    pass


def _path(kp) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)


def _flat_jax(tree):
    return {_path(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg):
    b = {"tokens": (BATCH, SEQ), "targets": (BATCH, SEQ)}
    if cfg.family == "vlm":
        b["patches"] = (BATCH, cfg.num_patches, cfg.d_model)
    if cfg.family == "encdec":
        b["frames"] = (BATCH, cfg.enc_seq, cfg.d_model)
    return b


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    spec = jget_arch(arch)
    cfg = spec.model
    state = jax.eval_shape(lambda: JTR.init_train_state(cfg, spec.train,
                                                        jax.random.PRNGKey(0)))
    caches = jax.eval_shape(lambda: JT.init_caches(cfg, CACHE_BATCH, CACHE_LEN))
    batch = {k: jax.ShapeDtypeStruct(s, jnp.int32 if len(s) == 2 else jnp.float32)
             for k, s in _batch(cfg).items()}
    return cfg, state, caches, batch


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    """(params, optimizer moments, caches) of the port as {JAX path: shape}."""
    spec = get_arch(arch)
    cfg = spec.model
    with FakeTensorMode():
        state = TR.init_train_state(cfg, spec.train, 0, device="cpu")
        caches = T.init_caches(cfg, CACHE_BATCH, CACHE_LEN, device="cpu")
        named = list(state["params"].named_parameters())
        params = R.stacked_shapes(named)
        opt = {"count": ()}
        for m, tree in state["opt"].items():
            if m == "count":
                continue
            if m in ("mu", "nu"):
                opt.update({f"{m}/{k}": s for k, s in R.stacked_shapes(tree.items()).items()})
            else:
                opt.update({f"{m}/{k}": tuple(t.shape) for k, t in tree.items()})
        cache = R.stacked_shapes((k.replace("/", "."), t)
                                 for k, t in bridge.flatten(caches).items())
    return cfg, params, opt, cache


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax_entry_by_entry(arch, strategy, mesh_name):
    mesh = FakeMesh(shape=MESHES[mesh_name])
    jcfg, jstate, jcaches, jbatch = _jax_trees(arch)
    cfg, params, opt, cache = _port_shapes(arch)
    jrules, rules = JR.rules_for(arch, strategy), R.rules_for(arch, strategy)
    assert jrules == rules

    def jspecs(tree):
        return {k: tuple(v) for k, v in _flat_jax(tree).items()}

    want = jspecs(JR.param_specs(jstate["params"], mesh, jrules, jcfg, strategy))
    got = R.param_specs(params, mesh, rules, cfg, strategy)
    assert got == want
    want = jspecs(JR.opt_state_specs(jstate["opt"], mesh, jrules, jcfg, strategy))
    assert R.opt_state_specs(opt, mesh, rules, cfg, strategy) == want
    assert R.cache_specs(cache, mesh, rules) == jspecs(JR.cache_specs(jcaches, mesh, jrules))
    assert R.batch_specs(_batch(cfg), mesh, rules) == jspecs(
        JR.batch_specs(jbatch, mesh, jrules))
