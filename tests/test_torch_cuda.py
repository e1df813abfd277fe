"""The port's CUDA kernels and model path on the card, against their plain
versions. These need an NVIDIA GPU and skip elsewhere; on a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed."""
import dataclasses

import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer as T
from repro_torch.training import train as TR

pytestmark = pytest.mark.cuda

# bf16: one rounding of the output; fp32: another summation order, TF32 off.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("R,D", [(4, 2048), (1000, 2048), (77, 2050), (3, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(cuda, R, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(R + D)
    x = _randn(gen, (R, D), dtype, cuda)
    s = _randn(gen, (D,), torch.float32, cuda)
    before = ops.LAUNCHES["rmsnorm"]
    y = ops.rmsnorm(x, s)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    torch.testing.assert_close(y.float(), ref.reference_rmsnorm(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("R,D,x_dtype,s_dtype,path", [
    (4096, 1024, torch.bfloat16, torch.bfloat16, "warp_per_row"),   # mamba2 pre-norms
    (4096, 2048, torch.bfloat16, torch.bfloat16, "warp_per_row"),   # gate_norm
    (4096, 4096, torch.bfloat16, torch.bfloat16, "warp_per_row"),   # zamba2 shared block
    (4, 1024, torch.bfloat16, torch.bfloat16, "block_per_row"),     # mamba2 decode
    (64, 2048, torch.float32, torch.float32, "block_per_row"),
    (1000, 2048, torch.float32, torch.float32, "warp_per_row"),
    (333, 4096, torch.bfloat16, torch.float32, "block_per_row"),
    (5, 8192, torch.bfloat16, torch.bfloat16, "block_per_row"),
    (77, 2050, torch.float32, torch.bfloat16, "scalar")])
def test_rmsnorm_kernel_paths(cuda, R, D, x_dtype, s_dtype, path):
    """The main-path shapes and one of each other path: the path that ran
    is the one ``plan`` names, and the result is the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(R + D)
    x = _randn(gen, (R, D), x_dtype, cuda)
    s = 1.0 + 0.1 * _randn(gen, (D,), s_dtype, cuda)
    y = ops.rmsnorm(x, s)
    assert rn.PLAN.path == path
    assert rn.PLAN == rn.plan(R, D, x_dtype, s_dtype,
                              sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    torch.testing.assert_close(y.float(), ref.reference_rmsnorm(x, s).float(),
                               atol=TOL[x_dtype], rtol=TOL[x_dtype])


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv,causal", [
    (2, 4, 4, 128, 128, 64, 64, True), (1, 8, 2, 200, 200, 128, 128, True),
    (2, 4, 4, 100, 100, 192, 128, True), (1, 4, 4, 130, 130, 64, 64, False),
    (1, 2, 1, 1, 1, 64, 64, True),
    (2, 4, 2, 70, 70, 16, 16, True),          # the reduced configs' head dim
    (1, 4, 4, 300, 300, 256, 256, True),      # D 256
    (1, 4, 4, 100, 260, 64, 64, False),       # Sq < Sk, cross-attention
    (1, 4, 4, 260, 100, 64, 64, True),        # Sq > Sk
    (2, 4, 2, 64, 1000, 128, 128, True),
    (1, 4, 4, 1000, 1000, 64, 64, True),      # ragged at 64 and at 128
    (1, 32, 8, 256, 256, 128, 128, True),     # GQA 32/8 at hd 128
    (1, 8, 2, 200, 330, 128, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, B, H, KH, Sq, Sk, D, Dv, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q = _randn(gen, (B, Sq, H, D), dtype, cuda).transpose(1, 2)
    k = _randn(gen, (B, Sk, KH, D), dtype, cuda).transpose(1, 2)
    v = _randn(gen, (B, Sk, KH, Dv), dtype, cuda).transpose(1, 2)
    before = ops.LAUNCHES["flash_attention"]
    o = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert fa.ROUTE == fa.ROUTES[dtype]
    assert o.shape == (B, H, Sq, Dv) and o.is_contiguous()
    torch.testing.assert_close(
        o.float(), ops.flash_attention_plain(q, k, v, causal=causal).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _ssd_inputs(gen, B, S, H, G, P, N, x_dtype, bc_dtype, device, decay=1.0):
    """x (B,S,H,P) dt-scaled, dA <= 0 (fp32), B and C (B,S,G,N) as
    ``ssm.apply_ssm_full`` hands them over: each a contiguous (B,S,G*N)
    projection viewed per group."""
    x = _randn(gen, (B, S, H, P), x_dtype, device)
    dA = -decay * torch.nn.functional.softplus(_randn(gen, (B, S, H), torch.float32, device))
    Bm, Cm = (0.5 * _randn(gen, (B, S, G * N), bc_dtype, device).reshape(B, S, G, N)
              for _ in range(2))
    return x, dA, Bm, Cm


@pytest.mark.parametrize("B,S,H,G,P,N,chunk,decay", [
    (2, 512, 8, 1, 64, 128, 256, 1.0), (1, 256, 8, 2, 64, 64, 256, 0.01),
    (2, 128, 4, 1, 64, 128, 256, 1.0), (1, 192, 3, 3, 48, 40, 64, 0.1),
    (1, 64, 2, 1, 16, 8, 16, 1.0),
    (1, 4096, 4, 1, 64, 128, 256, 0.01),    # the state carried over 16 chunks
    (1, 4096, 2, 1, 64, 64, 4096, 1.0),     # chunk = S = 4096
    (1, 256, 8, 1, 64, 128, 256, 1.0),      # batch 1, a single chunk
    (2, 512, 8, 2, 64, 64, 256, 1.0),       # G 2, four heads per group
    (1, 300, 6, 2, 128, 128, 100, 0.1),     # P = N = 128, ragged 64-row tiles
    (1, 128, 2, 1, 30, 20, 64, 1.0)])       # P not a multiple of 4: scalar copies
@pytest.mark.parametrize("x_dtype,bc_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_ssd_scan_kernel(cuda, B, S, H, G, P, N, chunk, decay, x_dtype, bc_dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + H + N)
    x, dA, Bm, Cm = _ssd_inputs(gen, B, S, H, G, P, N, x_dtype, bc_dtype, cuda, decay)
    before = ops.LAUNCHES["ssd_scan"]
    y, state = ops.ssd_scan(x, dA, Bm, Cm, chunk=chunk, return_state=True)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    want_y, want_state = ops.ssd_scan_plain(x, dA, Bm, Cm, chunk=min(chunk, S))
    # the Pallas kernel's own tolerance against its oracle: 10x (tests/test_kernels.py)
    tol = 10 * TOL[x_dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)


def test_ssd_scan_kernel_matches_the_recurrence(cuda):
    """The Pallas contract (BH, S, P) against the sequential oracle: y and
    the final state."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, dA, Bm, Cm = (t[:, :, 0] for t in _ssd_inputs(
        gen, 4, 128, 1, 1, 32, 16, torch.float32, torch.float32, cuda, 0.1))
    y, state = ops.ssd_scan(x, dA, Bm, Cm, chunk=32, return_state=True)
    want_y, want_state = ref.reference_ssd(x, dA, Bm, Cm)
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(state, want_state, atol=1e-3, rtol=1e-3)


def test_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.rmsnorm(x, torch.ones(16, device=cuda, dtype=torch.float16))
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[..., :32], q)
    qb = torch.zeros(1, 1, 8, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):  # bf16 D 40
        ops.flash_attention(qb, qb, qb)
    qb = torch.zeros(1, 1, 8, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):          # row stride 68
        ops.flash_attention(qb, qb, qb)
    # the ssd_scan backward takes what the forward takes (P and N up to 128)
    # and a final-state gradient of the state's shape; the flash backward
    # head dims up to 256, the rmsnorm backward dy in x's dtype
    x = torch.zeros(1, 64, 2, 16, device=cuda)
    dA = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 1, 16, device=cuda)
    _, st, cum, states = ssd.ssd_scan_cuda(x, dA, bc, bc, 64, True)
    with pytest.raises(ValueError, match="dstate"):
        ssd.ssd_scan_bwd_cuda(x, dA, bc, bc, 64, cum, states, st, torch.zeros_like(x),
                              torch.zeros(1, 2, 16, 15, device=cuda))
    wide = torch.zeros(1, 64, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd.ssd_scan_bwd_cuda(x, dA, wide, wide, 64, cum, states, st,
                              torch.zeros_like(x), None)
    xw = torch.zeros(1, 64, 2, 130, device=cuda)
    with pytest.raises(ValueError, match="P <= 128"):
        ssd.ssd_scan_bwd_cuda(xw, dA, bc, bc, 64, cum, states, st, torch.zeros_like(xw), None)
    with pytest.raises(ValueError, match="N <= 128"):   # under autograd, before any launch
        ops.ssd_scan(x.requires_grad_(True), dA, wide, wide)
    qw = torch.zeros(1, 2, 8, 272, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="up to 256"):
        ops.flash_attention(qw[..., :192], qw[..., :192], qw)
    with pytest.raises(TypeError):
        rn.rmsnorm_bwd_cuda(torch.zeros(4, 16, device=cuda), torch.ones(16, device=cuda),
                            torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16))
    x = torch.zeros(1, 64, 2, 16, device=cuda)
    dA = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 1, 256, device=cuda)
    with pytest.raises(ValueError):                 # N 256 > 128
        ops.ssd_scan(x, dA, bc, bc)
    with pytest.raises(TypeError):                  # dA must be fp32
        ops.ssd_scan(x, dA.bfloat16(), bc[..., :16], bc[..., :16])


@pytest.mark.parametrize("aid,kw,S", [
    ("stablelm-1.6b", {"num_kv_heads": 4}, 70), ("stablelm-1.6b", {"num_kv_heads": 2}, 70),
    ("mamba2-370m", {}, 64), ("zamba2-1.2b", {"num_layers": 5}, 64)])
def test_model_on_card_matches_cpu(cuda, aid, kw, S):
    cfg = reduced(get_arch(aid).model).replace(
        param_dtype="float32", compute_dtype="float32", **kw)
    params = T.init_lm(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want, _ = T.apply_lm(params, cfg, toks)
        got, _ = T.apply_lm(T.init_lm(cfg, 0, device="cpu").to(cuda), cfg,
                            toks.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _modality(cfg, B):
    """Seeded frames (encdec) or patches (vlm) of the config's shape."""
    name = TR.MODALITY_INPUT.get(cfg.family)
    if name is None:
        return {}
    n = cfg.num_patches if cfg.family == "vlm" else cfg.enc_seq
    return {name: torch.randn((B, n, cfg.d_model), generator=torch.Generator().manual_seed(3))}


@pytest.mark.parametrize("aid,kw", [("paligemma-3b", {}), ("vit-base-16", {}),
                                    ("whisper-large-v3", {}),
                                    ("whisper-large-v3", {"num_kv_heads": 2})])
def test_family_on_card_matches_cpu(cuda, aid, kw):
    """The reduced vlm and encdec models: logits on the card (prefix-LM,
    bidirectional encoder and cross-attention through the kernel) equal
    the CPU's, the forward's launches exactly the path's."""
    cfg = reduced(get_arch(aid).model).replace(
        param_dtype="float32", compute_dtype="float32", **kw)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    extra = _modality(cfg, 2)
    with torch.inference_mode():
        want, _ = T.apply_lm(T.init_lm(cfg, 0, device="cpu"), cfg, toks, **extra)
        ops.reset_launches()
        got, _ = T.apply_lm(T.init_lm(cfg, 0, device="cpu").to(cuda), cfg, toks.to(cuda),
                            **{k: v.to(cuda) for k, v in extra.items()})
    per_step = TR.kernel_launches_per_step(cfg, "none")
    assert ops.LAUNCHES == {k: (v if not k.endswith("_bwd") else 0) for k, v in per_step.items()}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# B, H, KH, Sq, Sk, D, prefix (None: non-causal), dtype: chip_smoke.py's
# cases at smaller batches, and the tile edges of the prefix
PREFIX_CASES = [
    (1, 8, 1, 384, 384, 256, 256, torch.bfloat16),     # paligemma serve, MQA hd 256
    (2, 12, 12, 212, 212, 64, 196, torch.bfloat16),    # vit train
    (1, 20, 20, 1500, 1500, 64, None, torch.bfloat16),  # whisper encoder
    (1, 20, 20, 4096, 1500, 64, None, torch.bfloat16),  # whisper cross
    (1, 4, 2, 100, 100, 48, 37, torch.float32),        # ragged small
    (1, 4, 2, 100, 100, 48, 37, torch.bfloat16),
    (1, 4, 2, 300, 300, 64, 127, torch.bfloat16),      # a tile's last key past the prefix
    (1, 4, 2, 300, 300, 128, 129, torch.bfloat16),     # one key past a dK/dV block
    (1, 4, 4, 260, 100, 64, 70, torch.float32),        # rows past every key
    (2, 12, 12, 212, 212, 64, 196, torch.float32)]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,prefix,dtype", PREFIX_CASES)
def test_flash_attention_prefix_kernel(cuda, B, H, KH, Sq, Sk, D, prefix, dtype):
    """The prefix-LM mask (and the non-causal mode of the encoder and the
    cross-attention) through the forward, its lse and, where the head dim
    allows it, the backward, each against the plain version on the card;
    the backward's two runs give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + (prefix or 0))
    q = _randn(gen, (B, Sq, H, D), dtype, cuda).transpose(1, 2)
    k = _randn(gen, (B, Sk, KH, D), dtype, cuda).transpose(1, 2)
    v = _randn(gen, (B, Sk, KH, D), dtype, cuda).transpose(1, 2)
    do = _randn(gen, (B, Sq, H * D), dtype, cuda).view(B, Sq, H, D).transpose(1, 2)
    causal, p = prefix is not None, prefix or 0
    o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True, prefix_len=p)
    o_plain, lse_plain = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                                   prefix_len=p)
    torch.testing.assert_close(o.float(), o_plain.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_plain, atol=1e-3, rtol=1e-4)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, p)
    want = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal, prefix_len=p)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), atol=TOL[dtype], rtol=TOL[dtype])
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, p)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_widths_bwd_under_a_prefix(cuda, dtype):
    """MLA's D 192, Dv 128 under the prefix-LM mask, forward and backward
    against the plain versions on the card, the backward's bits equal run
    to run."""
    gen = torch.Generator(device=cuda).manual_seed(192)
    B, H, S, D, Dv, p = 1, 4, 300, 192, 128, 100
    q = _randn(gen, (B, S, H, D), dtype, cuda).transpose(1, 2)
    k = _randn(gen, (B, S, H, D), dtype, cuda).transpose(1, 2)
    v = _randn(gen, (B, S, H, Dv), dtype, cuda).transpose(1, 2)
    do = _randn(gen, (B, S, H * Dv), dtype, cuda).view(B, S, H, Dv).transpose(1, 2)
    o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True, prefix_len=p)
    o_plain, lse_plain = ops.flash_attention_plain(q, k, v, return_lse=True, prefix_len=p)
    torch.testing.assert_close(o.float(), o_plain.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_plain, atol=1e-3, rtol=1e-4)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, p)
    want = ref.reference_attention_bwd(q, k, v, o, lse, do, prefix_len=p)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.BWD_ROUTE == fa.plan_bwd(q, k, v, p)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, p)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_zero_and_past_sk_give_the_plain_masks_bits(cuda, dtype):
    """prefix 0 launches give the causal kernel's bits, a prefix of Sk or
    more the non-causal kernel's, forward (o and lse) and backward."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, H, KH, S, D = 1, 4, 2, 300, 64
    q = _randn(gen, (B, S, H, D), dtype, cuda).transpose(1, 2)
    k, v = (_randn(gen, (B, S, KH, D), dtype, cuda).transpose(1, 2) for _ in range(2))
    do = _randn(gen, (B, H, S, D), dtype, cuda)
    for p, causal in ((0, True), (S, False), (S + 50, False)):
        o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True, prefix_len=p)
        o2, lse2 = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        g = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, p)
        g2 = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(g, g2))


def test_prefix_autograd_launches_and_refuses_wide_heads(cuda):
    """Under autograd a prefix call launches both kernels once, at head dim
    64, at paligemma's 256 and at MLA's 192/128 (the width-256 tile); past
    256 it raises before any launch: no fallback to the plain backward."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = _randn(gen, (1, 4, 120, 64), torch.bfloat16, cuda).requires_grad_(True)
    before = dict(ops.LAUNCHES)
    ops.flash_attention(q, q, q, prefix_len=50).sum().backward()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    wide = _randn(gen, (1, 8, 64, 256), torch.bfloat16, cuda).requires_grad_(True)
    kv = _randn(gen, (1, 1, 64, 256), torch.bfloat16, cuda)
    before = dict(ops.LAUNCHES)
    ops.flash_attention(wide, kv, kv, prefix_len=8).sum().backward()
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert fa.BWD_ROUTE == ("tensor_cores", (256, 32))
    mla_q = _randn(gen, (1, 8, 64, 192), torch.bfloat16, cuda).requires_grad_(True)
    mla_v = _randn(gen, (1, 8, 64, 128), torch.bfloat16, cuda)
    before = dict(ops.LAUNCHES)
    ops.flash_attention(mla_q, mla_q.detach(), mla_v, prefix_len=8).sum().backward()
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert fa.BWD_ROUTE == ("tensor_cores", (256, 32))
    past = torch.zeros(1, 8, 64, 272, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="up to 256") as refused:
        ops.flash_attention(past, past.detach(), mla_v, prefix_len=8)
    assert "queue" not in str(refused.value)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("R,D", [(4, 2048), (1000, 2048), (77, 2050), (3, 8192),
                                 (8192, 2048)])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_rmsnorm_bwd_kernel(cuda, R, D, x_dtype, s_dtype):
    gen = torch.Generator(device=cuda).manual_seed(R + D)
    x = _randn(gen, (R, D), x_dtype, cuda)
    s = 1.0 + 0.1 * _randn(gen, (D,), s_dtype, cuda)
    dy = _randn(gen, (R, D), x_dtype, cuda)
    dx, ds = rn.rmsnorm_bwd_cuda(x, s, dy)
    want_dx, want_ds = ref.reference_rmsnorm_bwd(x, s, dy)
    assert dx.dtype == x_dtype and ds.dtype == s_dtype
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=TOL[x_dtype], rtol=TOL[x_dtype])
    # dscale sums R rows: the fp32 tolerance relative to its scale
    tol = TOL[s_dtype] if s_dtype == torch.bfloat16 else TOL[x_dtype]
    torch.testing.assert_close(ds.float(), want_ds.float(), atol=tol * R ** 0.5, rtol=tol)
    again = rn.rmsnorm_bwd_cuda(x, s, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)   # deterministic


@pytest.mark.parametrize("R,D,x_dtype,s_dtype,path", [
    (8192, 2048, torch.bfloat16, torch.bfloat16, "warp_per_row"),   # the train path
    (1000, 1024, torch.float32, torch.float32, "warp_per_row"),
    (1001, 512, torch.bfloat16, torch.float32, "warp_per_row"),     # ragged grid
    (8192, 2048, torch.float32, torch.float32, "block_per_row"),
    (4, 2048, torch.bfloat16, torch.bfloat16, "block_per_row"),     # few rows
    (333, 4096, torch.bfloat16, torch.float32, "block_per_row"),
    (3, 8192, torch.float32, torch.float32, "block_per_row"),
    (77, 2050, torch.float32, torch.bfloat16, "scalar"),
    (5, 4100, torch.bfloat16, torch.bfloat16, "scalar")])
def test_rmsnorm_bwd_kernel_paths(cuda, R, D, x_dtype, s_dtype, path):
    """Each path of ``plan_bwd``: the path that ran is the plan's, the
    gradients are the plain version's, and two runs give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(R + D + 1)
    x = _randn(gen, (R, D), x_dtype, cuda)
    s = 1.0 + 0.1 * _randn(gen, (D,), s_dtype, cuda)
    dy = _randn(gen, (R, D), x_dtype, cuda)
    dx, ds = rn.rmsnorm_bwd_cuda(x, s, dy)
    assert rn.PLAN_BWD.path == path
    assert rn.PLAN_BWD == rn.plan_bwd(
        R, D, x_dtype, s_dtype, sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    want_dx, want_ds = ref.reference_rmsnorm_bwd(x, s, dy)
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=TOL[x_dtype], rtol=TOL[x_dtype])
    tol = TOL[s_dtype] if s_dtype == torch.bfloat16 else TOL[x_dtype]
    torch.testing.assert_close(ds.float(), want_ds.float(), atol=tol * R ** 0.5, rtol=tol)
    again = rn.rmsnorm_bwd_cuda(x, s, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)


FLASH_BWD_CASES = [
    (2, 4, 4, 128, 128, 64, 64, True), (1, 8, 2, 200, 200, 128, 128, True),
    (1, 4, 4, 130, 130, 64, 64, False), (2, 4, 2, 70, 70, 16, 16, True),
    (1, 4, 4, 100, 260, 64, 64, False), (1, 4, 4, 260, 100, 64, 64, True),
    (1, 4, 4, 100, 260, 64, 64, True),        # keys past every query: zero dk, dv
    (1, 32, 8, 256, 256, 128, 128, True),     # GQA 32/8 at hd 128
    (1, 6, 2, 1000, 1000, 64, 64, True),      # ragged at 64, batch 1
    (1, 1, 1, 1, 1, 64, 64, True),
    (2, 4, 4, 96, 96, 64, 32, False),          # Dv != D
    # the edges of the bf16 tiles: 128-key dK/dV blocks, 128-row dQ blocks,
    # 64-key tiles, q steps of 64 (width 64) and 32 (width 128)
    (1, 2, 2, 127, 127, 64, 64, True), (1, 2, 2, 129, 129, 64, 64, True),
    (1, 2, 1, 4096, 4096, 64, 64, True),      # the train path's length
    (1, 4, 2, 129, 300, 64, 64, True),        # Sk > Sq, ragged blocks of both
    (1, 4, 4, 127, 385, 128, 128, False),     # Sk > Sq at width 128
    (1, 2, 2, 129, 129, 128, 128, True),      # ragged q steps of 32
    (1, 2, 2, 100, 100, 64, 128, True),       # D 64 padded to width 128
    (1, 1, 1, 300, 300, 64, 64, True),        # batch 1, one head
    # width 256: 64-key dK/dV blocks shared by both warpgroups, 32-key dQ tiles
    (1, 8, 1, 300, 300, 256, 256, True),      # paligemma's MQA, ragged
    (1, 2, 2, 129, 200, 256, 256, False),     # Sk > Sq, non-causal
    (2, 2, 1, 65, 65, 256, 256, True),        # one key past a 64-key block
    (1, 2, 2, 100, 100, 160, 160, True),      # 160 padded to width 256
    # MLA's 192/128 on the width-256 tile, Q/K and V/dO zero-padded
    (1, 8, 8, 300, 300, 192, 128, True),      # ragged, causal
    (1, 2, 2, 129, 200, 192, 128, False),     # Sk > Sq, non-causal
    (2, 4, 4, 65, 65, 192, 128, True)]        # one key past a 64-key block


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv,causal", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(cuda, B, H, KH, Sq, Sk, D, Dv, causal, dtype):
    """The forward's lse against the plain version's, then the backward
    against the plain FA2 recurrence on the same o and lse, with do a
    transposed view of a (B, S, H*Dv) gradient as the model hands it over."""
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + Dv)
    q = _randn(gen, (B, Sq, H, D), dtype, cuda).transpose(1, 2)
    k = _randn(gen, (B, Sk, KH, D), dtype, cuda).transpose(1, 2)
    v = _randn(gen, (B, Sk, KH, Dv), dtype, cuda).transpose(1, 2)
    do = _randn(gen, (B, Sq, H * Dv), dtype, cuda).view(B, Sq, H, Dv).transpose(1, 2)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
    o_plain, lse_plain = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(o.float(), o_plain.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_plain, atol=1e-3, rtol=1e-4)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    want = ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for got, w, like in zip((dq, dk, dv), want, (q, k, v)):
        assert got.dtype == dtype and got.shape == like.shape and got.stride() == like.stride()
        torch.testing.assert_close(got.float(), w.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.BWD_ROUTE == fa.plan_bwd(q, k, v)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))   # no atomics


def test_serve_forward_leaves_lse_unwritten(cuda):
    """Without ``return_lse`` the forward takes no lse and its output is the
    one the training path gets."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (2, 4, 128, 64), torch.bfloat16, cuda)
    o = fa.flash_attention_cuda(q, q, q, True)
    o2, lse = fa.flash_attention_cuda(q, q, q, True, return_lse=True)
    assert torch.equal(o, o2) and lse.shape == (2, 4, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_on_card_matches_cpu(cuda, dtype):
    """``ops.rmsnorm`` and ``ops.flash_attention`` under autograd: the card
    launches each backward kernel once and its gradients are the CPU's
    (the plain versions through the same autograd Functions)."""
    gen = torch.Generator().manual_seed(7)
    B, H, KH, S, D = 2, 8, 2, 150, 64
    base = [torch.randn(s, generator=gen).to(dtype) for s in
            [(B, S, H, D), (B, S, KH, D), (B, S, KH, D), (B, H, S, D), (S, 256), (256,)]]

    def run(device):
        q, k, v, x, s = (base[i].to(device).requires_grad_(True) for i in (0, 1, 2, 4, 5))
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        y = ops.rmsnorm(x, s)
        torch.autograd.backward([o, y], [base[3].to(device), torch.ones_like(y)])
        return [t.grad.cpu().float() for t in (q, k, v, x, s)]

    before = dict(ops.LAUNCHES)
    got = run(cuda)
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert ops.LAUNCHES["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
    tol = TOL[dtype] * (5 if dtype == torch.bfloat16 else 1)
    for g, w in zip(got, run("cpu")):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("aid,kw,S", [
    ("stablelm-1.6b", {"num_layers": 3, "num_kv_heads": 2}, 64),
    ("mamba2-370m", {"num_layers": 3}, 64),
    ("zamba2-1.2b", {"num_layers": 5}, 64),
    ("paligemma-3b", {}, 64), ("whisper-large-v3", {}, 64), ("vit-base-16", {}, 64),
    ("olmoe-1b-7b", {}, 64), ("deepseek-v3-671b", {}, 64)],
    ids=["stablelm", "mamba2", "zamba2", "paligemma", "whisper", "vit", "olmoe",
         "deepseek"])
def test_train_steps_on_card_match_cpu(cuda, remat, aid, kw, S):
    """Reduced models in fp32: two steps on the card through the kernels
    and on the CPU through the plain versions, from the same init; the
    card's launches per step are the path's exactly."""
    cfg = reduced(get_arch(aid).model).replace(
        param_dtype="float32", compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(get_arch(aid).train, remat=remat)
    cpu_state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    card_state = bridge.state_from_jax(
        bridge.unflatten(bridge.state_to_flat(cpu_state)), cfg, cuda)
    step = TR.make_train_step(cfg, tcfg)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], **_modality(cfg, 2)}
    expect = TR.kernel_launches_per_step(cfg, remat)
    for _ in range(2):
        ops.reset_launches()
        card_state, m_card = step(card_state, TR.to_device(batch, cuda))
        assert ops.LAUNCHES == expect
        cpu_state, m_cpu = step(cpu_state, TR.to_device(batch, "cpu"))
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(m_card[key].cpu(), m_cpu[key], atol=1e-4, rtol=1e-4)


SSD_CASES = [
    (2, 512, 8, 1, 64, 128, 256, 1.0), (1, 256, 8, 2, 64, 64, 256, 0.01),
    (2, 128, 4, 1, 64, 128, 256, 1.0), (1, 192, 3, 3, 48, 40, 64, 0.1),
    (1, 64, 2, 1, 16, 8, 16, 1.0),
    (1, 4096, 4, 1, 64, 128, 256, 0.01),    # the state carried over 16 chunks
    (1, 4096, 2, 1, 64, 64, 4096, 1.0),     # chunk = S = 4096
    (1, 256, 8, 1, 64, 128, 256, 1.0),      # batch 1, a single chunk
    (2, 512, 8, 2, 64, 64, 256, 1.0),       # G 2, four heads per group
    (1, 300, 6, 2, 128, 128, 100, 0.1),     # P = N = 128, ragged 64-row tiles
    (1, 128, 2, 1, 30, 20, 64, 1.0),        # P not a multiple of 4
    (1, 512, 6, 2, 64, 128, 256, 0.1),      # 3 heads a group
    (1, 256, 6, 1, 64, 64, 128, 1.0),       # 6 heads a group
    (2, 256, 1, 1, 64, 128, 128, 0.01)]     # H 1


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _chunk_grads_instances(fn):
    """The chunk_grads instances that ``fn`` launches, by ``torch.profiler``'s
    kernel names (``build.kernel_instance``), and the kernels of each trace.
    A trace without chunk_grads (the profiler at times drops a kernel) is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    traces = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traces.append([e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA])
        found = sorted({build.kernel_instance(n) for n in traces[-1] if "chunk_grads" in n})
        if found:
            break
    return found, traces


def _check_ssd_bwd(cuda, B, S, H, G, P, N, chunk, decay, bc_dtype, with_dstate):
    chunk = min(chunk, S)
    gen = torch.Generator(device=cuda).manual_seed(S + H + N + 1)
    x, dA, Bm, Cm = _ssd_inputs(gen, B, S, H, G, P, N, torch.float32, bc_dtype, cuda, decay)
    dy = _randn(gen, (B, S, H, P), torch.float32, cuda)
    ds = _randn(gen, (B, H, N, P), torch.float32, cuda) if with_dstate else None
    _, st, cum, states = ssd.ssd_scan_cuda(x, dA, Bm, Cm, chunk, True)

    def run():
        return ssd.ssd_scan_bwd_cuda(x, dA, Bm, Cm, chunk, cum, states, st, dy, ds)

    got = run()
    plan = ssd.plan_bwd(N, P, chunk, H // G, bc_dtype, tiles=B * G * (S // chunk) * -(-chunk // 64),
                        sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert ssd.BWD_PLAN == plan
    found, traces = _chunk_grads_instances(run)
    assert found == [plan.kernel], traces
    want = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk)
    limits = (1e-4, 1e-4) + ((1e-4, 1e-4) if bc_dtype == torch.float32 else (1e-3, 1e-3))
    for i, (g, w, like) in enumerate(zip(got, want, (x, dA, Bm, Cm))):
        assert g.shape == like.shape and g.dtype == like.dtype and g.is_contiguous()
        assert _rel(g, w) <= limits[i]
        tol = 10 * TOL[g.dtype]
        atol = tol * chunk ** 0.5 if i == 1 else tol
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=tol)
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    return plan


@pytest.mark.parametrize("B,S,H,G,P,N,chunk,decay", SSD_CASES)
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_scan_bwd_kernel(cuda, B, S, H, G, P, N, chunk, decay, bc_dtype, with_dstate):
    """The backward against ``ref.ssd_scan_bwd`` on the forward kernel's
    scratch: each gradient by norm (1e-4, and 1e-3 on dB and dC with bf16
    B/C, where they come back in bf16) and elementwise at the forward's
    10x tolerance of its dtype (d dA, a sum of up to ``chunk`` rows, with
    its atol scaled by sqrt(chunk)); two runs give equal bits (no
    atomics); the chunk_grads instance that ran (``torch.profiler``) is
    the one ``plan_bwd`` picks for the card's SMs (fp32 B and C at N = P =
    128: one head a block, no cp.async ring)."""
    _check_ssd_bwd(cuda, B, S, H, G, P, N, chunk, decay, bc_dtype, with_dstate)


@pytest.mark.parametrize("B,S,H,G,P,N,chunk,decay,heads", [
    (2, 4096, 8, 1, 64, 128, 256, 0.01, (2, 1)),    # N 128: blocks of two (mamba2's)
    (2, 4096, 6, 2, 64, 128, 256, 0.1, (2, 1)),     # 3 heads a group: blocks of 2 and 1
    (2, 4096, 6, 1, 64, 64, 256, 1.0, (4, 2)),      # 6 heads a group: blocks of 4 and 2
    (1, 4096, 16, 1, 64, 64, 256, 1.0, (4, 2))])    # N 64: blocks of four (zamba2's)
@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_bwd_kernel_head_blocks(cuda, B, S, H, G, P, N, chunk, decay, heads, bc_dtype):
    """The same checks on grids large enough for blocks of several heads of
    a group (``heads``: with bf16 B/C, with fp32), a group's last block
    holding fewer where they do not divide its heads, with a final-state
    gradient."""
    plan = _check_ssd_bwd(cuda, B, S, H, G, P, N, chunk, decay, bc_dtype, True)
    assert plan.heads_per_block == heads[bc_dtype == torch.float32]


def test_ssd_scan_bwd_sees_the_carried_state_gradient(cuda):
    """Slow decay over 8 chunks with a final-state gradient: the kernel is
    within 1e-4 of the plain backward by norm, and the plain backward
    without the carried state gradient is not, so the check can see a
    kernel that drops it."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, dA, Bm, Cm = _ssd_inputs(gen, 2, 2048, 8, 1, 64, 128, torch.float32,
                                torch.float32, cuda, 0.01)
    dy = _randn(gen, (2, 2048, 8, 64), torch.float32, cuda)
    ds = _randn(gen, (2, 8, 128, 64), torch.float32, cuda)
    _, st, cum, states = ssd.ssd_scan_cuda(x, dA, Bm, Cm, 256, True)
    got = ssd.ssd_scan_bwd_cuda(x, dA, Bm, Cm, 256, cum, states, st, dy, ds)
    want = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=256)
    control = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=256, carry_state_grad=False)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= 1e-4
    assert _rel(control[0], want[0]) > 1e-4


@pytest.mark.parametrize("three_d", [False, True])
def test_ssd_scan_autograd_launches_the_backward_kernel(cuda, three_d):
    """``ops.ssd_scan`` under autograd on the card: one ``ssd_scan`` and one
    ``ssd_scan_bwd`` launch, and gradients equal to the CPU's (the plain
    versions through the same Function), for the model layout and the
    Pallas contract, with and without a final-state gradient."""
    gen = torch.Generator().manual_seed(3)
    shape = (3, 192, 16) if three_d else (2, 192, 4, 16)
    base = [torch.randn(shape, generator=gen),
            -0.05 * torch.rand(shape[:-1], generator=gen),
            torch.randn(shape[:2] + ((8,) if three_d else (2, 8)), generator=gen),
            torch.randn(shape[:2] + ((8,) if three_d else (2, 8)), generator=gen)]
    dy = torch.randn(shape, generator=gen)
    ds = torch.randn(shape[:1] + (() if three_d else (4,)) + (8, 16), generator=gen)

    def run(device):
        leaves = [t.to(device).requires_grad_(True) for t in base]
        y, st = ops.ssd_scan(*leaves, chunk=64, return_state=True)
        torch.autograd.backward([y, st], [dy.to(device), ds.to(device)])
        return [t.grad.cpu() for t in leaves]

    ops.reset_launches()
    got = run(cuda)
    assert ops.LAUNCHES["ssd_scan"] == 1 and ops.LAUNCHES["ssd_scan_bwd"] == 1
    for g, w in zip(got, run("cpu")):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)


def test_profiled_workflow_step_fences_the_card(cuda):
    """A profiled step of the port's engine that launches card work and
    returns a CUDA tensor without a sync: its ``execute_s`` covers the work's
    device time by CUDA events (unfenced it would read the launches only),
    and ``device_bytes_in_use`` the tensor. The step allocates nothing and
    cuBLAS is warm before it, so nothing in it waits for the card."""
    from repro_torch.core import couler
    from repro_torch.core.engines.local import LocalEngine
    a = torch.randn(4096, 4096, device=cuda) / 64.0
    out = torch.empty_like(a)
    torch.mm(a, a, out=out)
    torch.cuda.synchronize()
    events = []

    def work():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):                      # about 50 ms of fp32 products
            torch.mm(a, a, out=out)
        end.record()
        events.append((start, end))
        return out

    with couler.workflow("fence") as ir:
        couler.run_step(work, step_name="work", cacheable=False)
    eng = LocalEngine(profile_steps=True, enable_speculation=False)
    try:
        run = eng.submit(ir)
    finally:
        eng.close()
    assert run.succeeded(), run.steps["work"].error
    assert run.artifacts["work:out"].is_cuda
    start, end = events[0]
    end.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    prof = run.steps["work"].profile
    assert "compile_s" not in prof
    assert prof["execute_s"] >= device_s > 0.01
    assert prof["device_bytes_in_use"] >= 2 * out.numel() * out.element_size()


def test_content_key_of_a_card_tensor_is_the_cpu_tensors(cuda):
    from repro_torch.core.engines.local import _hash_value
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert _hash_value({"w": t.to(cuda)}) == _hash_value({"w": t})
    assert _hash_value(t.to(cuda).t()) == _hash_value(t.t().contiguous())


# ---------------------------------------------------------------------------
# the moe family's widths: MLA's (192, 128) flash under its strides, olmoe's
# 16 heads of 128 backward, the norms of 7168, 1536 and 512
# ---------------------------------------------------------------------------

def test_flash_forward_at_mla_width_under_its_strides(cuda):
    """MLA hands the kernel q and k concatenated (nope 128 + rope 64) and v
    a strided view of the latent's product, every head's 128 values 256
    apart (``attention.apply_mla_full``): the (192, 128) tile."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, nope, rope, vd = 2, 130, 16, 128, 64, 128
    q = _randn(gen, (B, S, H, nope + rope), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, H, nope + rope), torch.bfloat16, cuda)
    kv = _randn(gen, (B, S, H, nope + vd), torch.bfloat16, cuda)
    v = kv[..., nope:]
    assert not v.is_contiguous()
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert fa.plan(*args) == ("tensor_cores", (192, 128))
    before = ops.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        o = ops.flash_attention(*args, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention_plain(*args, causal=True)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_backward_at_olmoe_heads(cuda):
    """16 heads of 128 through the autograd Function, as olmoe's layers
    hand them over; gradients against the plain backward's by norm."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, S, H, D = 1, 512, 16, 128
    q, k, v = (_randn(gen, (B, S, H, D), torch.bfloat16, cuda).transpose(1, 2)
               .requires_grad_(True) for _ in range(3))
    do = _randn(gen, (B, H, S, D), torch.bfloat16, cuda)
    before = ops.LAUNCHES["flash_attention_bwd"]
    grads = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    assert fa.BWD_ROUTE == ("tensor_cores", (128, 32))
    o, lse = ops.flash_attention_plain(q.detach(), k.detach(), v.detach(), return_lse=True)
    want = ref.reference_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do)
    for g, w in zip(grads, want):
        assert ((g.float() - w.float()).norm() / w.float().norm()).item() < 1e-2


@pytest.mark.parametrize("D", [7168, 1536, 512])
@pytest.mark.parametrize("R", [4, 512])
def test_rmsnorm_at_the_moe_widths(cuda, R, D):
    """deepseek's d_model 7168, MLA's q_norm 1536 and kv_norm 512, bf16,
    forward and backward."""
    gen = torch.Generator(device=cuda).manual_seed(R + D)
    x = _randn(gen, (R, D), torch.bfloat16, cuda).requires_grad_(True)
    s = (1.0 + 0.1 * _randn(gen, (D,), torch.float32, cuda)).bfloat16().requires_grad_(True)
    dy = _randn(gen, (R, D), torch.bfloat16, cuda)
    y = ops.rmsnorm(x, s)
    torch.testing.assert_close(y.float(), ref.reference_rmsnorm(x.detach(), s.detach()).float(),
                               atol=2e-2, rtol=2e-2)
    dx, ds = torch.autograd.grad(y, (x, s), dy)
    wdx, wds = ref.reference_rmsnorm_bwd(x.detach(), s.detach(), dy)
    torch.testing.assert_close(dx.float(), wdx.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(ds.float(), wds.float(), atol=2e-2 * R ** 0.5, rtol=2e-2)


def test_olmoe_train_steps_give_equal_bits(cuda):
    """Two runs of two bf16 steps from one state: equal params, as a
    content-keyed cache needs; the dispatch has no atomics."""
    cfg = reduced(get_arch("olmoe-1b-7b").model).replace(d_model=128, moe_d_ff=128)
    tcfg = get_arch("olmoe-1b-7b").train
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator().manual_seed(1))
    batch = TR.to_device({"tokens": toks[:, :-1], "targets": toks[:, 1:]}, cuda)
    runs = []
    for _ in range(2):
        state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
        step = TR.make_train_step(cfg, tcfg)
        for _ in range(2):
            state, m = step(state, batch)
        runs.append([p.detach().clone() for p in state["params"].parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_a_card_tensor_literal_argument_keys_as_the_cpu_one(cuda):
    from repro_torch.core import couler
    from repro_torch.core.engines.local import cache_key

    def use(t):
        return float(t.sum())

    def job(arg):
        with couler.workflow("lit") as ir:
            couler.run_step(use, arg, step_name="use")
        return ir.jobs["use"]

    t = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    t2 = t.clone()
    t2[2048] += 1
    assert cache_key(job(t.to(cuda)), {}) == cache_key(job(t), {})
    assert cache_key(job(t2.to(cuda)), {}) != cache_key(job(t.to(cuda)), {})
