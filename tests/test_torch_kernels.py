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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
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



@pytest.mark.parametrize("D,Dv,tile", [
    (16, 16, (64, 64)), (64, 64, (64, 64)), (64, 128, (128, 128)),
    (128, 128, (128, 128)), (80, 48, (128, 128)), (192, 128, (192, 128)),
    (192, 192, (256, 256)), (256, 256, (256, 256))])
def test_flash_bf16_tile_choice(D, Dv, tile):
    """The smallest instantiated tile pair that holds D and Dv."""
    assert fa.bf16_tile(D, Dv) == tile


@pytest.mark.parametrize("D,Dv", [(40, 40), (64, 40), (8, 8), (272, 256)])
def test_flash_bf16_tile_refuses(D, Dv):
    with pytest.raises(ValueError):
        fa.bf16_tile(D, Dv)


def test_flash_plan_routes_by_dtype():
    """The launcher's checks are pure Python and run on any device: bf16 goes
    to the tensor cores with its tile, fp32 to the CUDA cores, and what the
    chosen kernel cannot take raises before anything launches."""
    q = torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16)
    assert fa.plan(q, q, q) == ("tensor_cores", (64, 64))
    assert fa.plan(q.float(), q.float(), q.float()) == ("cuda_cores", None)
    qm = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16).transpose(1, 2)
    assert fa.plan(qm, qm, qm) == ("tensor_cores", (64, 64))   # model layout, hd 16
    k, v = torch.zeros(2, 2, 300, 192, dtype=torch.bfloat16), torch.zeros(2, 2, 300, 128, dtype=torch.bfloat16)
    assert fa.plan(torch.zeros(2, 4, 8, 192, dtype=torch.bfloat16), k, v) == \
        ("tensor_cores", (192, 128))                             # GQA, Sq != Sk, Dv != D
    odd = torch.zeros(3, 1, 8, 64, dtype=torch.bfloat16).as_strided((1, 1, 8, 64), (7, 3, 64, 1))
    assert fa.plan(odd, odd, odd)[0] == "tensor_cores"           # size-1 dims: any stride
    assert fa._strides(odd) == [0, 0, 64]
    with pytest.raises(TypeError):
        fa.plan(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiples of 16"):
        q40 = torch.zeros(1, 1, 8, 40, dtype=torch.bfloat16)
        fa.plan(q40, q40, q40)
    with pytest.raises(ValueError, match="16-byte"):             # row stride 68
        q68 = torch.zeros(1, 1, 8, 68, dtype=torch.bfloat16)[..., :64]
        fa.plan(q68, q68, q68)
    with pytest.raises(ValueError, match="16-byte"):             # starts 8 bytes in
        q4 = torch.zeros(1, 1, 8, 72, dtype=torch.bfloat16)[..., 4:68]
        fa.plan(q4, q4, q4)
    q40 = torch.zeros(1, 1, 8, 40)
    assert fa.plan(q40, q40, q40) == ("cuda_cores", None)       # fp32 takes any D

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("R,D,xd,sd,want", [
    # the main paths' shapes: decode (few rows: 256 threads a row) and the
    # forwards of stablelm, mamba2, zamba2 (a warp a row)
    (4, 2048, BF, BF, ("block_per_row", 4, 256, 1)),
    (4, 1024, BF, BF, ("block_per_row", 4, 256, 1)),
    (512, 2048, BF, BF, ("warp_per_row", 128, 128, 8)),
    (4096, 1024, BF, BF, ("warp_per_row", 264, 128, 4)),
    (4096, 2048, BF, BF, ("warp_per_row", 264, 128, 8)),
    (4096, 4096, BF, BF, ("warp_per_row", 528, 128, 16)),
    (1000, 2048, BF, BF, ("warp_per_row", 250, 128, 8)),
    (64, 2048, F32, F32, ("block_per_row", 64, 256, 2)),
    (264, 2048, F32, F32, ("warp_per_row", 66, 128, 16)),
    # wider rows than a warp holds: 256 threads a row
    (333, 4096, BF, F32, ("block_per_row", 333, 256, 2)),
    (3, 8192, F32, F32, ("block_per_row", 3, 256, 8)),
    (4096, 8192, BF, BF, ("block_per_row", 528, 256, 4)),
    (4, 4096, F32, F32, ("block_per_row", 4, 256, 4)),
    # no 16-byte accesses: D not a multiple of the vector
    (77, 2050, F32, BF, ("scalar", 77, 256, 0)),
    (5, 4100, BF, BF, ("scalar", 5, 256, 0))])
def test_rmsnorm_plan(R, D, xd, sd, want):
    """The path and launch shape the wrapper hands the kernel, on any
    device: (path, grid, threads per block, 16-byte vectors per thread)."""
    p = rn.plan(R, D, xd, sd)
    assert (p.path, p.grid, p.threads, p.vectors) == want


def test_rmsnorm_plan_unaligned_and_refusals():
    assert rn.plan(4096, 1024, BF, BF, aligned=False).path == "scalar"
    assert rn.plan(10 ** 6, 1024, BF, BF, sms=100).grid == 200   # 100 SMs x 2
    with pytest.raises(TypeError):
        rn.plan(4, 64, torch.float16, BF)
    with pytest.raises(ValueError):
        rn.plan(4, 8193, BF, BF)


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
