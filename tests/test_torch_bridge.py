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
from repro_torch.models import transformer as T
from repro_torch.models.ssm import FP32_PARAMS


# Per arch, a config change that makes the reduced model exercise its layout:
# GQA for the dense one, a leftover layer after the groups for the hybrid one.
ARCHS = {"stablelm-1.6b": {"num_kv_heads": 2}, "mamba2-370m": {},
         "zamba2-1.2b": {"num_layers": 5}}


def _setup(dtype, aid="stablelm-1.6b"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **ARCHS[aid])
    cfg = reduced(get_arch(aid).model).replace(**kw)
    jc = jreduced(jget_arch(aid).model).replace(**kw)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    return cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("aid", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_exact(dtype, aid):
    cfg, _, np_tree = _setup(dtype, aid)
    tp = bridge.params_from_jax(np_tree, cfg, "cpu")
    # the ssm blocks keep dt_bias, A_log and D_skip in fp32, as JAX draws them
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {p.dtype for n, p in tp.named_parameters()
            if n.rsplit(".", 1)[-1] not in FP32_PARAMS} == {want}
    if cfg.family == "hybrid":
        assert [len(g) for g in tp["groups"]] == [2, 2] and len(tp["leftover"]) == 1
    else:
        assert len(tp["layers"]) == cfg.num_layers
    back = bridge.params_to_numpy(tp)
    src, out = bridge.flatten(np_tree), bridge.flatten(back)
    assert src.keys() == out.keys()
    for k in src:
        assert out[k].shape == src[k].shape, k
        np.testing.assert_array_equal(out[k], np.asarray(src[k], np.float32), k)
    again = bridge.params_from_jax(back, cfg, "cpu", dtype=want)
    for (n1, p1), (n2, p2) in zip(tp.named_parameters(), again.named_parameters()):
        assert n1 == n2 and p1.dtype == p2.dtype and torch.equal(p1, p2)


@pytest.mark.parametrize("aid", list(ARCHS))
def test_keys_follow_checkpoint_paths(aid):
    cfg, jp, np_tree = _setup("float32", aid)
    leaves, _ = tree_flatten_with_path(jp)
    assert set(bridge.flatten(np_tree)) == {_path_str(p) for p, _ in leaves}
    # the port's own init_lm builds the same tree: names, shapes and types
    want = {k: (v.shape, v.dtype) for k, v in bridge.flatten(np_tree).items()}
    got = bridge.flatten(bridge.params_to_numpy(T.init_lm(cfg, 0, device="cpu")))
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == want


def test_layer_count_mismatch_raises():
    cfg, _, np_tree = _setup("float32")
    with pytest.raises(ValueError, match="stacked layers"):
        bridge.params_from_jax(np_tree, cfg.replace(num_layers=3), "cpu")


def test_dtype_cast_on_import():
    cfg, _, np_tree = _setup("bfloat16")
    tp = bridge.params_from_jax(np_tree, cfg, "cpu", dtype=torch.float32)
    assert {p.dtype for p in tp.parameters()} == {torch.float32}


def test_dtype_cast_keeps_fp32_ssm_leaves():
    """Under a bfloat16 param type JAX keeps dt_bias, A_log and D_skip in
    float32; so does the import, and their values pass unrounded."""
    cfg, _, np_tree = _setup("float32", "mamba2-370m")
    rng = np.random.default_rng(0)
    np_tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape).astype(np.float32)
                         if _path_str(path).rsplit("/", 1)[-1] in FP32_PARAMS else a),
        np_tree)
    tp = bridge.params_from_jax(np_tree, cfg.replace(param_dtype="bfloat16"), "cpu",
                                dtype=torch.bfloat16)
    src = bridge.flatten(np_tree)
    for name, p in tp.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in FP32_PARAMS else torch.bfloat16), name
    back = bridge.flatten(bridge.params_to_numpy(tp))
    for k in src:
        if k.rsplit("/", 1)[-1] in FP32_PARAMS:
            np.testing.assert_array_equal(back[k], src[k], k)
