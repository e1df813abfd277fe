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
from repro_torch.kernels import ssd_scan as ssd
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


# ---------------------------------------------------------------------------
# backward: the plain versions and the autograd wrappers against jax.vjp
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.models import layers as JL  # noqa: E402


def _attn_inputs(seed, B, H, KH, Sq, Sk, D, Dv):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, Dv), (B, H, Sq, Dv)]]
    return arrs, [torch.from_numpy(a) for a in arrs]


def _jax_attention_vjp(arrs, causal, H, KH):
    """jax.vjp of the model-level blockwise attention (K/V repeated for
    GQA inside the function, so their cotangents sum over the group)."""
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    Sq, Sk = q.shape[2], k.shape[2]
    qpos = jnp.arange(Sq, dtype=jnp.int32)
    kpos = jnp.arange(Sk, dtype=jnp.int32)
    if not causal:                  # every key visible: positions before every query
        kpos = jnp.full((Sk,), -1, dtype=jnp.int32)

    def f(q, k, v):
        return jax_blockwise(q, jnp.repeat(k, H // KH, axis=1),
                             jnp.repeat(v, H // KH, axis=1), qpos, kpos, block=64)
    _, vjp = jax.vjp(f, q, k, v)
    return vjp(do)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv", [
    (2, 4, 2, 70, 70, 16, 16), (1, 4, 4, 40, 100, 16, 24), (1, 6, 2, 130, 130, 32, 32)])
def test_reference_attention_bwd_matches_jax_blockwise(causal, B, H, KH, Sq, Sk, D, Dv,
                                                       monkeypatch):
    monkeypatch.setattr(ref, "ATTN_BWD_BLOCK", 48)     # several blocks, a ragged last
    arrs, (q, k, v, do) = _attn_inputs(Sq + Sk + D, B, H, KH, Sq, Sk, D, Dv)
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    dq, dk, dv = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for want, got in zip(_jax_attention_vjp(arrs, causal, H, KH), (dq, dk, dv)):
        _close(want, got, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_bwd_matches_jax_reference(causal):
    """The Pallas contract (BH, S, D): jax.vjp of the JAX oracle
    ``reference_attention`` against the plain backward with H = KH = 1."""
    rng = np.random.default_rng(31)
    arrs = [rng.standard_normal((3, 50, 8)).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jref.reference_attention(q, k, v, causal=causal),
                     jq, jk, jv)
    q, k, v, do = (torch.from_numpy(a)[:, None] for a in arrs)
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for want, g in zip(vjp(jdo), got):
        _close(want, g[:, 0], TOL["float32"])


def test_reference_attention_bwd_no_valid_key_is_zero():
    """A row whose lse is -inf (no visible key) takes no gradient."""
    _, (q, k, v, do) = _attn_inputs(3, 1, 2, 2, 8, 8, 16, 16)
    o, lse = ops.flash_attention_plain(q, k, v, return_lse=True)
    lse[:, :, 2] = float("-inf")
    dq, dk, dv = ref.reference_attention_bwd(q, k, v, o, lse, do)
    assert torch.all(dq[:, :, 2] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.parametrize("R,D", [(7, 24), (64, 48), (33, 100)])
def test_reference_rmsnorm_bwd_matches_jax(R, D):
    (jx, js, jdy), (tx, ts, tdy) = _inputs(R + D, [(R, D), (D,), (R, D)], "float32")
    js, ts = 1.0 + 0.1 * js, 1.0 + 0.1 * ts
    _, vjp = jax.vjp(lambda x, s: JL.apply_rmsnorm({"scale": s}, x), jx, js)
    jdx, jds = vjp(jdy)
    dx, ds = ref.reference_rmsnorm_bwd(tx, ts, tdy)
    assert dx.dtype == tx.dtype and ds.dtype == ts.dtype
    _close(jdx, dx, TOL["float32"])
    _close(jds, ds, TOL["float32"])


def test_reference_rmsnorm_bwd_keeps_dtypes():
    x = torch.randn(6, 32).bfloat16()
    s = torch.ones(32)
    dx, ds = ref.reference_rmsnorm_bwd(x, s, torch.randn(6, 32).bfloat16())
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_autograd_matches_jax(causal):
    """``ops.flash_attention`` under autograd on the CPU (the autograd
    Function with the plain forward and backward) against jax.vjp, in the
    model's transposed layout with GQA."""
    B, H, KH, S, D = 2, 4, 2, 90, 16
    arrs, _ = _attn_inputs(41, B, H, KH, S, S, D, D)
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
               .requires_grad_(True) for a in arrs[:3])
    before = dict(ops.LAUNCHES)
    o = ops.flash_attention(q, k, v, causal=causal)
    o.backward(torch.from_numpy(arrs[3]))
    assert ops.LAUNCHES == before          # the plain versions launch nothing
    for want, t in zip(_jax_attention_vjp(arrs, causal, H, KH), (q, k, v)):
        _close(want, t.grad, TOL["float32"])


def test_ops_rmsnorm_autograd_matches_jax():
    (jx, js, jdy), (tx, ts, tdy) = _inputs(5, [(40, 64), (64,), (40, 64)], "float32")
    js, ts = 1.0 + 0.1 * js, (1.0 + 0.1 * ts)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    ops.rmsnorm(tx, ts).backward(tdy)
    _, vjp = jax.vjp(lambda x, s: JL.apply_rmsnorm({"scale": s}, x), jx, js)
    jdx, jds = vjp(jdy)
    _close(jdx, tx.grad, TOL["float32"])
    _close(jds, ts.grad, TOL["float32"])


def test_flash_plan_bwd_refuses_wide_heads():
    """MLA's 192/128 is taken on both routes (bf16 on the width-256 tile);
    past 256 the plan refuses before any launch, naming the limit alone."""
    q = torch.zeros(1, 2, 8, 192)
    v = torch.zeros(1, 2, 8, 128)
    assert fa.plan_bwd(q, q, v) == ("cuda_cores", None)
    assert fa.plan_bwd(q.bfloat16(), q.bfloat16(), v.bfloat16()) == ("tensor_cores", (256, 32))
    wide = torch.zeros(1, 2, 8, 272)
    with pytest.raises(ValueError, match="up to 256") as refused:
        fa.plan_bwd(q, q, wide)
    assert "queue" not in str(refused.value) and "slice" not in str(refused.value)
    fa.plan_bwd(q[..., :128], q[..., :128], v)     # D 128 is taken
    with pytest.raises(TypeError):
        fa.plan_bwd(q.half()[..., :64], q.half()[..., :64], v.half()[..., :64])


# ---------------------------------------------------------------------------
# the backward kernels' designs: their tiling and summation order, in plain
# PyTorch, against jax.vjp; and the plans that pick their paths
# ---------------------------------------------------------------------------

def _has_valid_pair(q0, q1, k0, k1, Sq, Sk, causal):
    """Whether rows [q0, q1) and keys [k0, k1), cut to Sq and Sk, hold a
    pair the mask lets through (key <= row under the causal mask)."""
    q1, k1 = min(q1, Sq), min(k1, Sk)
    return q0 < q1 and k0 < k1 and (not causal or k0 <= q1 - 1)


def _tiles_with_a_valid_pair(H, KH, Sq, Sk, causal, q_step):
    """The (warpgroup half, tile) products a kernel must run, counted by
    brute force over every tile of the grid."""
    half = fa.BWD_KEYS // 2
    dkdv = sum(_has_valid_pair(q0, q0 + q_step, kw0, kw0 + half, Sq, Sk, causal)
               for kw0 in range(0, -(-Sk // fa.BWD_KEYS) * fa.BWD_KEYS, half)
               for q0 in range(0, Sq, q_step)) * H
    dq = sum(_has_valid_pair(q0w, q0w + half, k0, k0 + fa.BWD_KEY_TILE, Sq, Sk, causal)
             for q0w in range(0, -(-Sq // fa.BWD_Q_ROWS) * fa.BWD_Q_ROWS, half)
             for k0 in range(0, Sk, fa.BWD_KEY_TILE)) * H
    return {"dkdv": dkdv, "dq": dq}


@pytest.mark.parametrize("B,H,KH,Sq,Sk,causal", [
    (1, 2, 1, 127, 127, True), (1, 2, 1, 129, 129, True),    # 128-key and 128-row edges
    (2, 4, 2, 200, 200, True), (1, 4, 2, 129, 300, False),
    (1, 2, 2, 100, 260, True),                                # keys past every query
    (1, 2, 2, 260, 100, True), (1, 1, 1, 1, 1, True)])
@pytest.mark.parametrize("q_step", [64, 32])                  # widths 64 and 128
def test_flash_bwd_tiling_matches_jax(B, H, KH, Sq, Sk, causal, q_step):
    """The bf16 backward's decomposition (128-key dK/dV blocks in two
    halves, q tiles of ``q_step`` from the block's first key on, dQ over
    64-key tiles in order, tiles skipped where every pair is masked)
    against jax.vjp of the model's blockwise attention; it runs exactly the
    tiles that hold a valid pair."""
    D = Dv = 16
    arrs, (q, k, v, do) = _attn_inputs(Sq + Sk + q_step, B, H, KH, Sq, Sk, D, Dv)
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    dq, dk, dv, visits = ref.attention_bwd_tiles(
        q, k, v, o, lse, do, causal=causal, q_step=q_step, keys=fa.BWD_KEYS,
        q_rows=fa.BWD_Q_ROWS, key_tile=fa.BWD_KEY_TILE)
    for want, got in zip(_jax_attention_vjp(arrs, causal, H, KH), (dq, dk, dv)):
        _close(want, got, TOL["float32"])
    assert visits == _tiles_with_a_valid_pair(H, KH, Sq, Sk, causal, q_step)


def test_flash_bwd_tiling_no_valid_key_is_zero():
    """A row whose lse is -inf takes P = exp2(-(+inf)) = 0 in the kernels'
    log2 units, so no gradient, as in the plain backward."""
    _, (q, k, v, do) = _attn_inputs(4, 1, 2, 2, 70, 70, 16, 16)
    o, lse = ops.flash_attention_plain(q, k, v, return_lse=True)
    lse[:, :, 5] = float("-inf")
    got = ref.attention_bwd_tiles(q, k, v, o, lse, do)[:3]
    want = ref.reference_attention_bwd(q, k, v, o, lse, do)
    assert torch.all(got[0][:, :, 5] == 0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("D,Dv,want", [(64, 64, (64, 64)), (16, 16, (64, 64)),
                                       (64, 128, (128, 32)), (128, 128, (128, 32)),
                                       (80, 48, (128, 32)), (256, 256, (256, 32)),
                                       (160, 160, (256, 32)), (192, 128, (256, 32)),
                                       (256, 128, (256, 32))])
def test_flash_bwd_tile_choice(D, Dv, want):
    assert fa.bwd_tile(D, Dv) == want
    q = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 8, Dv, dtype=torch.bfloat16)
    assert fa.plan_bwd(q, q, v) == ("tensor_cores", want)
    assert fa.plan_bwd(q.float(), q.float(), v.float()) == ("cuda_cores", None)


@pytest.mark.parametrize("R,D,sms,path", [
    (40, 64, 4, "warp_per_row"), (70, 1024, 4, "warp_per_row"),
    (37, 48, 32, "block_per_row"), (30, 2048, 2, "block_per_row"),
    (9, 66, 4, "scalar")])
def test_rmsnorm_bwd_partials_match_jax(R, D, sms, path):
    """The backward's order of summation on each path (per-warp or
    per-block dscale partials, warps added in order, then the blocks in
    eight strided slices), with the plan's grid, against jax.vjp of the
    model's RMSNorm."""
    (jx, js, jdy), (tx, ts, tdy) = _inputs(R * D, [(R, D), (D,), (R, D)], "float32")
    js, ts = 1.0 + 0.1 * js, 1.0 + 0.1 * ts
    p = rn.plan_bwd(R, D, torch.float32, torch.float32, sms=sms)
    assert p.path == path
    dx, ds, partials = ref.rmsnorm_bwd_partials(tx, ts, tdy, path=p.path, grid=p.grid)
    assert partials.shape == (p.grid, D)
    _, vjp = jax.vjp(lambda x, s: JL.apply_rmsnorm({"scale": s}, x), jx, js)
    jdx, jds = vjp(jdy)
    _close(jdx, dx, TOL["float32"])
    _close(jds, ds, TOL["float32"])
    torch.testing.assert_close(partials.sum(0), ds, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("R,D,xd,sd,want", [
    # the train path's (8192, 2048): a warp a row in bf16, a block in fp32
    (8192, 2048, BF, BF, ("warp_per_row", 264, 128, 8)),
    (8192, 2048, F32, F32, ("block_per_row", 264, 256, 2)),
    (1000, 2048, BF, BF, ("warp_per_row", 250, 128, 8)),
    (1000, 1024, F32, F32, ("warp_per_row", 250, 128, 8)),
    (264, 512, BF, F32, ("warp_per_row", 66, 128, 2)),
    # a wider scale than a warp holds, or too few rows for two per SM
    (8192, 2048, BF, F32, ("block_per_row", 264, 256, 1)),
    (263, 1024, BF, BF, ("block_per_row", 263, 256, 1)),
    (4, 2048, BF, BF, ("block_per_row", 4, 256, 1)),
    (3, 8192, F32, F32, ("block_per_row", 3, 256, 8)),
    (333, 4096, BF, BF, ("block_per_row", 264, 256, 2)),
    # no 16-byte accesses
    (77, 2050, F32, BF, ("scalar", 77, 256, 0)),
    (5, 4100, BF, BF, ("scalar", 5, 256, 0))])
def test_rmsnorm_plan_bwd(R, D, xd, sd, want):
    """The backward's path and launch shape, on any device: (path, grid,
    threads per block, 16-byte vectors of x per thread)."""
    p = rn.plan_bwd(R, D, xd, sd)
    assert (p.path, p.grid, p.threads, p.vectors) == want


def test_rmsnorm_plan_bwd_unaligned_and_refusals():
    assert rn.plan_bwd(8192, 2048, BF, BF, aligned=False).path == "scalar"
    assert rn.plan_bwd(10 ** 6, 1024, BF, BF, sms=100).grid == 200   # 100 SMs x 2
    assert rn.plan_bwd(0, 64, BF, BF).grid == 1                      # dscale is then 0
    with pytest.raises(TypeError):
        rn.plan_bwd(4, 64, torch.float16, BF)
    for D in (0, 8193):
        with pytest.raises(ValueError):
            rn.plan_bwd(4, D, BF, BF)


@pytest.mark.parametrize("N,P,Q,rep,bc,want", [
    # the train paths: mamba2 (N 128) and zamba2 (N 64), bf16 B/C
    (128, 64, 256, 32, BF, ("bf16_bc", 2, True, (64, 128), 191488)),
    (64, 64, 256, 64, BF, ("bf16_bc", 4, True, (64, 64), 226304)),
    (64, 64, 4096, 1, BF, ("bf16_bc", 1, True, (64, 64), 137216)),   # one head: rep 1
    (128, 128, 100, 3, BF, ("bf16_bc", 1, True, (128, 128), 227328)),
    # fp32 B/C, or P = 128: fewer heads, then no ring, where they do not fit
    (128, 64, 256, 32, F32, ("split_bc", 1, True, (64, 128), 230400)),
    (40, 48, 64, 2, F32, ("split_bc", 2, True, (64, 64), 202752)),
    (64, 128, 256, 8, F32, ("split_bc", 1, False, (128, 64), 189440)),
    (128, 128, 100, 3, F32, ("split_bc", 1, False, (128, 128), 230400))])
def test_ssd_plan_bwd(N, P, Q, rep, bc, want):
    """The backward's route and chunk_grads' blocking, on any device: (route,
    heads a block, ring, padded widths, shared memory), each under a
    block's 227 KB, and the instance it names."""
    p = ssd.plan_bwd(N, P, Q, rep, bc)
    assert (p.route, p.heads_per_block, p.ring, p.widths, p.smem) == want
    assert p.smem <= ssd.MAX_BLOCK_SMEM
    tb = "bf16" if bc == BF else "float"
    assert p.kernel == (f"chunk_grads_kernel<{tb},{want[3][0]},{want[3][1]},{want[1]},"
                        f"{str(want[2]).lower()}>")


@pytest.mark.parametrize("B,S,H,G,N,chunk,sms,want", [
    (2, 4096, 32, 1, 128, 256, 132, 2),    # mamba2 train: 2048 blocks of two heads
    (2, 4096, 64, 1, 64, 256, 132, 4),     # zamba2 train: 2048 blocks of four
    (2, 512, 8, 2, 64, 256, 132, 1),       # grouped: 32 blocks of four, 128 of one
    (1, 384, 64, 1, 64, 128, 132, 2),      # 96 blocks of four, 192 of two
    (1, 384, 64, 1, 64, 128, 64, 4),       # a card of 64 SMs: four fill it
    (2, 512, 8, 2, 64, 256, 1, 4),         # one SM: the most heads that fit
    (1, 128, 2, 1, 20, 64, 132, 1)])       # ragged: 2 blocks, or 4
def test_ssd_plan_bwd_fills_the_card(B, S, H, G, N, chunk, sms, want):
    """Heads a block: the most that fit, unless that leaves SMs without a
    block (one an SM) and fewer would not; then fewer, down to one."""
    tiles = B * G * (S // chunk) * -(-chunk // ssd.TILE)
    assert ssd.plan_bwd(N, 64, chunk, H // G, BF, tiles=tiles, sms=sms).heads_per_block == want


def test_ssd_split_pieces_are_the_sources():
    """``ROUTE_PIECES`` holds the numbers of ``Pieces`` in csrc/ssd_scan.cu,
    which the kernels are built with, and ``SPLIT_PIECES`` gives each product
    the pieces of its operands' kinds."""
    import re
    from pathlib import Path
    src = (Path(ssd.__file__).parents[1] / "csrc" / "ssd_scan.cu").read_text()
    types = {"bf16_bc": "__nv_bfloat16", "split_bc": "float"}
    for route, tb in types.items():
        m = re.search(r"struct Pieces<" + tb + r"> \{[^}]*?kF = (\d+), kT = (\d+), kBC = (\d+);",
                      src)
        assert m is not None
        assert ssd.ROUTE_PIECES[route] == dict(zip(("F", "T", "BC"), map(int, m.groups())))
    assert ssd.SPLIT_PIECES["bf16_bc"]["T2 B"] == (2, 1)
    assert ssd.SPLIT_PIECES["split_bc"]["C B^T"] == (3, 3)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::chunk_grads_kernel<__nv_bfloat16, 64, 128, 2, true>"
     "((anonymous namespace)::BwdParams)", "chunk_grads_kernel<bf16,64,128,2,true>"),
    ("_ZN12_GLOBAL__N_118chunk_grads_kernelIfLi128ELi64ELi1ELb0EEEvNS_9BwdParamsE",
     "chunk_grads_kernel<float,128,64,1,false>"),
    ("(anonymous namespace)::dA_scan_kernel((anonymous namespace)::BwdParams)",
     "dA_scan_kernel")])
def test_kernel_instance_names(name, want):
    """A launched kernel's name, demangled or not, in ptxas_summary's form."""
    from repro_torch.kernels import build
    assert build.kernel_instance(name) == want


def test_ptxas_summary_names_each_instance():
    """nvcc's ptxas lines become one record per kernel, its template
    arguments (types, widths, heads, ring) in the name."""
    from repro_torch.kernels import build
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118chunk_grads_kernelI13__nv_bfloat16Li64ELi128ELi2ELb1EEEvNS_9BwdParamsE'"
        " for 'sm_90a'",
        "ptxas info    : Used 128 registers, 8 bytes smem",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118chunk_grads_kernelIfLi128ELi64ELi1ELb0EEEvNS_9BwdParamsE'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 255 registers"])
    assert build.ptxas_summary(log) == [
        {"kernel": "chunk_grads_kernel<bf16,64,128,2,true>", "registers": 128,
         "spill_stores": 0, "smem": 8},
        {"kernel": "chunk_grads_kernel<float,128,64,1,false>", "registers": 255,
         "spill_stores": 16, "smem": 0}]


def test_ssd_plan_bwd_terms_and_refusals():
    """bf16 B/C: C B^T one exact product, the decayed tiles' products two
    or three terms, dy x^T and the cross-chunk products three pieces each
    (six terms; three by a bf16 B or C); fp32 B/C: six everywhere."""
    bf = ssd.plan_bwd(128, 64, 256, 32, BF).terms
    assert bf == {"C B^T": 1, "dy x^T": 6, "T1^T dy": 3, "T2^T C": 2, "T2 B": 2,
                  "G_c^T B": 3, "G_c x": 6, "h_c dy": 6, "C^T (e o dy)": 3}
    assert set(ssd.plan_bwd(128, 64, 256, 32, F32).terms.values()) == {6}
    with pytest.raises(TypeError):
        ssd.plan_bwd(128, 64, 256, 32, torch.float16)
    for N, P, Q, rep in ((129, 64, 256, 1), (128, 0, 256, 1), (64, 64, 4097, 1),
                         (64, 64, 256, 0)):
        with pytest.raises(ValueError):
            ssd.plan_bwd(N, P, Q, rep, BF)


@pytest.mark.parametrize("D,Dv,match", [(272, 272, "up to 256"), (256, 272, "up to 256"),
                                        (272, 128, "up to 256"), (192, 384, "up to 256")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_refuses_past_its_widths(D, Dv, match, dtype):
    """Past 256 the backward's plan refuses on any device, before any
    launch, and so does the tile choice; D != Dv is taken up to 256."""
    q = torch.zeros(1, 2, 8, D, dtype=dtype)
    v = torch.zeros(1, 2, 8, Dv, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa.plan_bwd(q, q, v)
    with pytest.raises(ValueError, match=match):
        fa.bwd_tile(D, Dv)


def _wide_tiles_with_a_valid_pair(H, Sq, Sk, prefix, q_step, keys, key_tile):
    """The width-256 tiling's products, by brute force: a dK/dV block of
    ``keys`` keys that both warpgroups take whole, per q tile of ``q_step``
    rows; a dQ warpgroup's 64 rows per ``key_tile``-key tile."""
    def valid(q0, q1, k0, k1):
        q1, k1 = min(q1, Sq), min(k1, Sk)
        return q0 < q1 and k0 < k1 and (k0 <= q1 - 1 or k0 < prefix)
    half = fa.BWD_KEYS // 2
    dkdv = sum(valid(q0, q0 + q_step, k0, k0 + keys)
               for k0 in range(0, Sk, keys) for q0 in range(0, Sq, q_step)) * H
    dq = sum(valid(q0w, q0w + half, k0, k0 + key_tile)
             for q0w in range(0, -(-Sq // fa.BWD_Q_ROWS) * fa.BWD_Q_ROWS, half)
             for k0 in range(0, Sk, key_tile)) * H
    return {"dkdv": dkdv, "dq": dq}


@pytest.mark.parametrize("B,H,KH,S,prefix", [
    (1, 4, 1, 384, 256),           # paligemma's MQA and 256-patch prefix, cut to 384
    (1, 2, 1, 300, 100),           # ragged: a prefix inside a 64-key block
    (1, 2, 2, 130, 0)])            # the plain causal mask, one row past a dQ block
def test_flash_bwd_tiling_at_width_256_matches_jax(B, H, KH, S, prefix):
    """The width-256 backward's decomposition (``bwd_tile`` and ``bwd_blocks``
    at 256/256: 64-key dK/dV blocks shared by both warpgroups, q steps of
    32, dQ over 32-key tiles) under the prefix-LM mask at head dim 256,
    against jax.vjp of the model's blockwise attention; it visits exactly
    the tiles that hold a valid pair."""
    D = 256
    width, q_step = fa.bwd_tile(D, D)
    keys, key_tile = fa.bwd_blocks(width)
    assert (width, q_step, keys, key_tile) == (256, 32, 64, 32)
    arrs, (q, k, v, do) = _attn_inputs(S + prefix + D, B, H, KH, S, S, D, D)
    o, lse = ops.flash_attention_plain(q, k, v, return_lse=True, prefix_len=prefix)
    dq, dk, dv, visits = ref.attention_bwd_tiles(
        q, k, v, o, lse, do, q_step=q_step, keys=keys, q_rows=fa.BWD_Q_ROWS,
        key_tile=key_tile, half=keys, prefix_len=prefix)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    pos = jnp.arange(S, dtype=jnp.int32)

    def f(q, k, v):
        return jax_blockwise(q, jnp.repeat(k, H // KH, axis=1), jnp.repeat(v, H // KH, axis=1),
                             pos, pos, prefix_len=jnp.int32(prefix), block=64)
    _, vjp = jax.vjp(f, jq, jk, jv)
    for want, got in zip(vjp(jdo), (dq, dk, dv)):
        _close(want, got, TOL["float32"])
    assert visits == _wide_tiles_with_a_valid_pair(H, S, S, prefix, q_step, keys, key_tile)


@pytest.mark.parametrize("H,KH,S,prefix,causal", [
    (4, 4, 200, 0, True),          # MLA's causal training path, ragged
    (2, 2, 130, 50, True),         # a prefix inside a 64-key block
    (2, 1, 97, 0, False)])         # non-causal, GQA
def test_flash_bwd_at_mla_widths_matches_jax(H, KH, S, prefix, causal):
    """deepseek-v3's D 192 (nope 128 + rope 64), Dv 128: the plan takes it on
    both routes (bf16 on the width-256 tile, whose zero columns add nothing),
    and the plain backward and the width-256 tiling (``bwd_tile``,
    ``bwd_blocks``) at those widths match jax.vjp of the model's blockwise
    attention (fp32 2e-5)."""
    D, Dv = 192, 128
    arrs, (q, k, v, do) = _attn_inputs(S + D + prefix, 1, H, KH, S, S, D, Dv)
    assert fa.plan_bwd(q, k, v, prefix) == ("cuda_cores", None)
    bf = [t.bfloat16() for t in (q, k, v)]
    width, q_step = fa.bwd_tile(D, Dv)
    assert fa.plan_bwd(*bf, prefix) == ("tensor_cores", (width, q_step)) == (
        "tensor_cores", (256, 32))
    keys, key_tile = fa.bwd_blocks(width)
    o, lse = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                       prefix_len=prefix)
    plain = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal, prefix_len=prefix)
    tiled = ref.attention_bwd_tiles(q, k, v, o, lse, do, causal=causal, q_step=q_step,
                                    keys=keys, q_rows=fa.BWD_Q_ROWS, key_tile=key_tile,
                                    half=keys, prefix_len=prefix)[:3]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    pos = jnp.arange(S, dtype=jnp.int32)

    def f(q, k, v):
        kw = {"prefix_len": jnp.int32(prefix)} if prefix else {}
        qpos = pos if causal else jnp.full((S,), S, jnp.int32)
        return jax_blockwise(q, jnp.repeat(k, H // KH, axis=1), jnp.repeat(v, H // KH, axis=1),
                             qpos, pos, block=64, **kw)
    _, vjp = jax.vjp(f, jq, jk, jv)
    for want, a, b in zip(vjp(jdo), plain, tiled):
        assert a.shape == b.shape and a.shape[-1] in (D, Dv)
        _close(want, a, TOL["float32"])
        _close(want, b, TOL["float32"])
