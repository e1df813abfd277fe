"""The weight bridge: JAX parameter trees in and out of the port, exactly,
keyed as the JAX package's checkpoints key them."""
import jax
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import transformer as JT
from repro.training.checkpoint import _path_str
from repro_torch import bridge
from repro_torch.configs import get_arch, reduced


def _setup(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, num_kv_heads=2)
    cfg = reduced(get_arch("stablelm-1.6b").model).replace(**kw)
    jc = jreduced(jget_arch("stablelm-1.6b").model).replace(**kw)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    return cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_exact(dtype):
    cfg, _, np_tree = _setup(dtype)
    tp = bridge.params_from_jax(np_tree, cfg, "cpu")
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {p.dtype for p in tp.parameters()} == {want}
    assert len(tp["layers"]) == cfg.num_layers
    back = bridge.params_to_numpy(tp)
    src, out = bridge.flatten(np_tree), bridge.flatten(back)
    assert src.keys() == out.keys()
    for k in src:
        assert out[k].shape == src[k].shape, k
        np.testing.assert_array_equal(out[k], np.asarray(src[k], np.float32), k)
    again = bridge.params_from_jax(back, cfg, "cpu", dtype=want)
    for (n1, p1), (n2, p2) in zip(tp.named_parameters(), again.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)


def test_keys_follow_checkpoint_paths():
    _, jp, np_tree = _setup("float32")
    leaves, _ = tree_flatten_with_path(jp)
    assert set(bridge.flatten(np_tree)) == {_path_str(p) for p, _ in leaves}


def test_layer_count_mismatch_raises():
    cfg, _, np_tree = _setup("float32")
    with pytest.raises(ValueError, match="stacked layers"):
        bridge.params_from_jax(np_tree, cfg.replace(num_layers=3), "cpu")


def test_dtype_cast_on_import():
    cfg, _, np_tree = _setup("bfloat16")
    tp = bridge.params_from_jax(np_tree, cfg, "cpu", dtype=torch.float32)
    assert {p.dtype for p in tp.parameters()} == {torch.float32}
