"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX kernels, which run as the JAX tests run them: Pallas in interpret mode
through ``repro.kernels.ops``. Inputs come from numpy seeds and are cast to
the working type on each side, so both see the same values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import blockwise_attention

# The JAX kernel tests' tolerances (tests/test_kernels.py): fp32 differs only
# in summation order, bf16 by one rounding of the output.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs])


def _close(jx, tx, tol):
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("R,D,br", [(256, 64, 128), (512, 128, 256),
                                    (128, 96, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(R, D, br, dtype):
    (jx,), (tx,) = _inputs(R + D, [(R, D)], dtype)
    (js,), (ts,) = _inputs(R * D, [(D,)], "float32")
    before = dict(ops.LAUNCHES)
    y = ops.rmsnorm(tx, ts)
    assert y.dtype == TORCH_DT[dtype] and y.shape == (R, D)
    _close(jops.rmsnorm(jx, js, block_rows=br), y, TOL[dtype])
    assert ops.LAUNCHES == before          # the plain version launches nothing


@pytest.mark.parametrize("S,D,blocks", [(128, 64, (128, 128)),
                                        (256, 128, (128, 64))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(S, D, blocks, dtype):
    jin, tin = _inputs(S + D, [(2, S, D)] * 3, dtype)
    o = ops.flash_attention(*tin)
    assert o.shape == (2, S, D) and o.dtype == TORCH_DT[dtype]
    _close(jops.flash_attention(*jin, block_q=blocks[0], block_k=blocks[1]),
           o, TOL[dtype])


def test_flash_attention_non_causal_matches_pallas():
    jin, tin = _inputs(9, [(1, 128, 32)] * 3, "float32")
    _close(jops.flash_attention(*jin, causal=False),
           ops.flash_attention(*tin, causal=False), TOL["float32"])


def test_flash_attention_mixed_v_dim_matches_pallas():
    jin, tin = _inputs(10, [(2, 128, 48), (2, 128, 48), (2, 128, 32)], "float32")
    o = ops.flash_attention(*tin)
    assert o.shape == (2, 128, 32)
    _close(jops.flash_attention(*jin), o, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_ragged_model_layout(causal):
    """4-D model layout, KH < H and S = 200 (no block divides it) against the
    JAX oracle on K/V heads repeated by hand."""
    B, H, KH, S, D = 2, 4, 2, 200, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        13, [(B, H, S, D), (B, KH, S, D), (B, KH, S, D)], "float32")
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    jk, jv = jnp.repeat(jk, H // KH, axis=1), jnp.repeat(jv, H // KH, axis=1)
    o_ref = jref.reference_attention(jq.reshape(B * H, S, D),
                                     jk.reshape(B * H, S, D),
                                     jv.reshape(B * H, S, D), causal=causal)
    _close(o_ref.reshape(B, H, S, D), o, 3e-5)


def test_blockwise_attention_ragged_matches_jax():
    """The plain model-level version at S = 200 with 64-key blocks (the last
    block padded), against the JAX one and against the kernel's wrapper."""
    B, H, S, hd = 2, 3, 200, 16
    jin, tin = _inputs(11, [(B, H, S, hd)] * 3, "float32")
    out = blockwise_attention(*tin, torch.arange(S), torch.arange(S), block=64)
    jpos = jnp.arange(S, dtype=jnp.int32)
    _close(jax_blockwise(*jin, jpos, jpos, block=64), out, 3e-5)
    np.testing.assert_allclose(out.numpy(), ops.flash_attention(*tin).numpy(),
                               atol=3e-5, rtol=3e-5)


def test_reference_oracles_match_jax():
    jin, tin = _inputs(21, [(3, 40, 8), (3, 40, 8), (3, 40, 12)], "float32")
    for causal in (True, False):
        _close(jref.reference_attention(*jin, causal=causal),
               ref.reference_attention(*tin, causal=causal), 1e-5)
    (jx, js), (tx, ts) = _inputs(22, [(7, 24), (24,)], "float32")
    _close(jref.reference_rmsnorm(jx, js), ref.reference_rmsnorm(tx, ts), 1e-6)


def test_mixed_devices_raise():
    x = torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ops.rmsnorm(x, torch.zeros(8, device="meta"))
