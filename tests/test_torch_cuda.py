"""The port's CUDA kernels and model path on the card, against their plain
versions. These need an NVIDIA GPU and skip elsewhere; on a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed."""
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import transformer as T

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
    w = torch.ones(16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        ops.rmsnorm(torch.zeros(4, 16, device=cuda), w)
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
