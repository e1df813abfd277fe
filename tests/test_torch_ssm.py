"""The port's ssd_scan, Mamba2 block and ssm/hybrid models against the JAX
package on the CPU, at reduced widths. The JAX kernel runs as the JAX tests
run it (Pallas in interpret mode through ``repro.kernels.ops``); weights are
drawn by JAX and carried over with ``bridge.params_from_jax``; other inputs
come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import bridge, configs
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

# fp32 on both sides; the sums run in another order, nothing else differs.
TOL = 1e-4
# The JAX kernel tests' tolerances (tests/test_kernels.py:16), which hold the
# Pallas ssd_scan to 10x of them (tests/test_kernels.py:70-73): its
# chunked sums run in another order than the sequential recurrence's.
KTOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(tx, jx, tol=TOL):
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32),
                               atol=tol, rtol=tol)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _ssd_inputs(seed, BH, S_, P, N, dtype):
    """x, dA (<= 0, fp32), B, C as (jax, torch) pairs holding the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S_, P)).astype(np.float32)
    dA = -np.log1p(np.exp(rng.standard_normal((BH, S_)))).astype(np.float32)
    Bm = 0.5 * rng.standard_normal((BH, S_, N)).astype(np.float32)
    Cm = 0.5 * rng.standard_normal((BH, S_, N)).astype(np.float32)
    jx = [jnp.asarray(x).astype(dtype), jnp.asarray(dA),
          jnp.asarray(Bm).astype(dtype), jnp.asarray(Cm).astype(dtype)]
    tx = [torch.from_numpy(x).to(TORCH_DT[dtype]), torch.from_numpy(dA),
          torch.from_numpy(Bm).to(TORCH_DT[dtype]),
          torch.from_numpy(Cm).to(TORCH_DT[dtype])]
    return jx, tx


@pytest.mark.parametrize("S_,P,N,chunk", [(128, 16, 32, 32), (256, 32, 16, 64),
                                          (128, 64, 64, 128), (64, 8, 8, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas(S_, P, N, chunk, dtype):
    """The Pallas contract (BH, S, P): the port's wrapper (its plain version
    on the CPU) against the Pallas kernel in interpret mode, and its final
    state against the sequential oracle's."""
    jin, tin = _ssd_inputs(S_ * P + N, 2, S_, P, N, dtype)
    before = dict(ops.LAUNCHES)
    y, state = ops.ssd_scan(*tin, chunk=chunk, return_state=True)
    assert ops.LAUNCHES == before           # the plain version launches nothing
    assert y.dtype == TORCH_DT[dtype] and y.shape == (2, S_, P)
    assert state.dtype == torch.float32 and state.shape == (2, N, P)
    tol = 10 * KTOL[dtype]
    _close(y, jops.ssd_scan(*jin, chunk=chunk), tol)
    _, h_ref = jref.reference_ssd(*jin)
    _close(state, h_ref, tol)
    assert torch.equal(ops.ssd_scan(*tin, chunk=chunk), y)


def test_ssd_scan_short_sequence_and_bad_chunk():
    """S < chunk runs as one chunk of S rows, as the Pallas kernel does; a
    chunk that does not divide S is refused."""
    jin, tin = _ssd_inputs(3, 3, 24, 8, 8, "float32")
    _close(ops.ssd_scan(*tin, chunk=256), jops.ssd_scan(*jin, chunk=256),
           10 * KTOL["float32"])
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(*tin, chunk=16)


def test_reference_ssd_matches_jax():
    jin, tin = _ssd_inputs(5, 3, 40, 12, 6, "float32")
    y, h = ref.reference_ssd(*tin)
    jy, jh = jref.reference_ssd(*jin)
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


def _chunked_inputs(seed, B, S_, H, G, P, N):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, H)))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S_, G, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S_, G, N))).astype(np.float32)
    return (xh, dt, a_log, Bm, Cm)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_jax(G):
    arrs = _chunked_inputs(10 + G, 2, 48, 4, G, 8, 16)
    y, state = S.ssd_chunked(*map(torch.from_numpy, arrs), chunk=16)
    jy, jstate = JS.ssd_chunked(*map(jnp.asarray, arrs), chunk=16)
    assert y.shape == (2, 48, 4, 8) and state.shape == (2, 4, 8, 16)
    _close(y, jy)
    _close(state, jstate)


def _cfgs(aid, **kw):
    kw = {"param_dtype": "float32", "compute_dtype": "float32", **kw}
    return (configs.reduced(configs.get_arch(aid).model).replace(**kw),
            jcfg.reduced(jcfg.get_arch(aid).model).replace(**kw))


def test_apply_ssm_full_and_decode_match_jax():
    cfg, jc = _cfgs("mamba2-370m")
    jp = JS.init_ssm(jax.random.PRNGKey(3), jc)
    tp = _t(jp)
    B, S_ = 2, 32
    x = np.random.default_rng(3).standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    _close(S.apply_ssm_full(tp, cfg, torch.from_numpy(x)),
           JS.apply_ssm_full(jp, jc, jnp.asarray(x)))
    cache = S.init_ssm_cache(cfg, B, device="cpu")
    jcache = JS.init_ssm_cache(jc, B)
    jdecode = jax.jit(lambda p, x, c: JS.apply_ssm_decode(p, jc, x, c))
    for i in range(S_):
        out, cache = S.apply_ssm_decode(tp, cfg, torch.from_numpy(x[:, i:i + 1]), cache)
        jout, jcache = jdecode(jp, jnp.asarray(x[:, i:i + 1]), jcache)
        _close(out, jout)
    for k in jcache:
        _close(cache[k], jcache[k])


def test_conv_step_promotes_like_jax():
    """A bf16 token against an fp32 window and bf16 weights: JAX promotes
    the window and the product to fp32, and so does the port."""
    rng = np.random.default_rng(4)
    u1, state, w = (rng.standard_normal(s).astype(np.float32)
                    for s in [(2, 1, 8), (2, 3, 8), (4, 8)])
    out, window = S._conv_step(torch.from_numpy(u1).bfloat16(),
                               torch.from_numpy(state),
                               torch.from_numpy(w).bfloat16())
    jout, jwindow = JS._conv_step(jnp.asarray(u1).astype(jnp.bfloat16),
                                  jnp.asarray(state),
                                  jnp.asarray(w).astype(jnp.bfloat16))
    assert out.dtype == window.dtype == torch.float32
    assert jout.dtype == jwindow.dtype == jnp.float32
    _close(out, jout, 1e-6)
    _close(window, jwindow, 0)


def _models(aid, seed, **kw):
    cfg, jc = _cfgs(aid, **kw)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jc)
    return cfg, jc, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg, "cpu")


@pytest.mark.parametrize("aid,kw", [("mamba2-370m", {}),
                                    ("zamba2-1.2b", {"num_layers": 5})],
                         ids=["mamba2", "zamba2_leftover"])
def test_apply_lm_and_decode_logits(aid, kw):
    cfg, jc, jp, tp = _models(aid, 7, **kw)
    if aid == "zamba2-1.2b":
        assert len(tp["groups"]) == 2 and len(tp["leftover"]) == 1
    B, S_ = 2, 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    assert logits.dtype == torch.float32 and logits.shape == (B, S_, cfg.padded_vocab)
    _close(logits, jlogits)

    caches = T.init_caches(cfg, B, S_, torch.float32, device="cpu")
    jcaches = JT.init_caches(jc, B, S_, jnp.float32)
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(S_):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]),
                                       caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches,
                               jnp.int32(i))
        _close(lg, jlg)
        _close(lg[:, 0], logits[:, i].numpy())   # decode == forward, in the port


@pytest.mark.parametrize("aid", ["mamba2-370m", "zamba2-1.2b"])
def test_bf16_forward_and_decode_close_to_jax(aid):
    """bf16 weights and compute, fp32 ssm caches: the decode step mixes
    types, which the port casts as JAX promotes them."""
    cfg, jc, jp, tp = _models(aid, 8, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    logits, _ = T.apply_lm(tp, cfg, torch.from_numpy(toks))
    jlogits, _ = jax.jit(lambda p, t: JT.apply_lm(p, jc, t))(jp, jnp.asarray(toks))
    # bf16 rounds at other places in the two frameworks: a looser bound.
    _close(logits, jlogits, 5e-2)
    caches = T.init_caches(cfg, 2, 4, torch.float32, device="cpu")
    jcaches = JT.init_caches(jc, 2, 4, jnp.float32)
    jdecode = jax.jit(lambda p, t, c, i: JT.apply_lm_decode(p, jc, t, c, i))
    for i in range(4):
        lg, caches = T.apply_lm_decode(tp, cfg, torch.from_numpy(toks[:, i:i + 1]),
                                       caches, i)
        jlg, jcaches = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcaches,
                               jnp.int32(i))
        _close(lg, jlg, 5e-2)


@pytest.mark.parametrize("G", [1, 2])
def test_chunk_passes_match_jax_ssd_chunked(G):
    """The CUDA kernel's three passes (chunk states, the scan over chunks,
    the outputs), as plain PyTorch, against JAX's ``ssd_chunked``: y and the
    final state, over three chunks."""
    arrs = _chunked_inputs(20 + G, 2, 48, 4, G, 8, 16)
    xh, dt, a_log, Bm, Cm = map(torch.from_numpy, arrs)
    dA = dt * -torch.exp(a_log)[None, None, :]
    y, state = ref.ssd_chunk_passes(xh * dt[..., None], dA, Bm, Cm, chunk=16)
    jy, jstate = JS.ssd_chunked(*map(jnp.asarray, arrs), chunk=16)
    _close(y, jy)
    _close(state.transpose(-1, -2), jstate)


@pytest.mark.parametrize("G,chunk", [(1, 32), (2, 16), (1, 128)])
def test_chunk_passes_match_pallas_and_the_recurrence(G, chunk):
    """The three passes against the Pallas kernel in interpret mode (per
    head, its (BH, S, P) contract) and against the sequential recurrence,
    y and the final state, at the Pallas tests' 10x tolerance."""
    B, S_, H, P, N = 2, 128, 4, 16, 8
    rng = np.random.default_rng(30 + G + chunk)
    x = rng.standard_normal((B, S_, H, P)).astype(np.float32)
    dA = -np.log1p(np.exp(rng.standard_normal((B, S_, H)))).astype(np.float32)
    Bm = 0.5 * rng.standard_normal((B, S_, G, N)).astype(np.float32)
    Cm = 0.5 * rng.standard_normal((B, S_, G, N)).astype(np.float32)
    y, state = ref.ssd_chunk_passes(*map(torch.from_numpy, (x, dA, Bm, Cm)),
                                    chunk=chunk)
    # per head: (B*H, S, ...) with each head's group of B and C
    grp = np.arange(H) // (H // G)
    xh = x.transpose(0, 2, 1, 3).reshape(B * H, S_, P)
    ah = dA.transpose(0, 2, 1).reshape(B * H, S_)
    Bh = Bm[:, :, grp].transpose(0, 2, 1, 3).reshape(B * H, S_, N)
    Ch = Cm[:, :, grp].transpose(0, 2, 1, 3).reshape(B * H, S_, N)
    jin = [jnp.asarray(a) for a in (xh, ah, Bh, Ch)]
    y_bh = y.permute(0, 2, 1, 3).reshape(B * H, S_, P)
    tol = 10 * KTOL["float32"]
    _close(y_bh, jops.ssd_scan(*jin, chunk=chunk), tol)
    y_rec, h_rec = ref.reference_ssd(*map(torch.from_numpy, (xh, ah, Bh, Ch)))
    _close(y_bh, y_rec.numpy(), tol)
    _close(state.reshape(B * H, N, P), h_rec.numpy(), tol)
    y_plain, state_plain = ops.ssd_scan_plain(*map(torch.from_numpy, (x, dA, Bm, Cm)),
                                              chunk=chunk)
    _close(y, y_plain.numpy(), TOL)
    _close(state, state_plain.numpy(), TOL)


def _bwd_inputs(seed, B, S_, H, G, P, N, decay):
    """x, dA (slow decay: -decay * softplus), B, C, dy and a final-state
    gradient from numpy, as float32 tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S_, H, P)),
            -decay * np.log1p(np.exp(rng.standard_normal((B, S_, H)))),
            0.5 * rng.standard_normal((B, S_, G, N)),
            0.5 * rng.standard_normal((B, S_, G, N)),
            rng.standard_normal((B, S_, H, P)),
            rng.standard_normal((B, H, N, P))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


def _rel_close(got, want, tol):
    """Each gradient within ``tol`` of its largest value."""
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.detach().float().numpy(), w.float().numpy(),
                                   rtol=0, atol=tol * scale)


@pytest.mark.parametrize("G,S_,chunk,decay", [(1, 96, 32, 0.01), (2, 64, 16, 0.01),
                                               (2, 96, 32, 1.0)])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_scan_bwd_matches_autograd(G, S_, chunk, decay, with_dstate):
    """The kernel's decomposition in plain PyTorch (``ref.ssd_scan_bwd``)
    against torch autograd through the chunked plain forward, over three or
    more chunks, with slow decay and a final-state gradient."""
    x, dA, Bm, Cm, dy, ds = _bwd_inputs(40 + G + S_, 2, S_, 4, G, 5, 6, decay)
    ds = ds if with_dstate else None
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm)]
    y, st = ops.ssd_scan_plain(*leaves, chunk=chunk)
    loss = (y * dy).sum() + ((st * ds).sum() if with_dstate else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk)
    for g, like in zip(got, (x, dA, Bm, Cm)):
        assert g.shape == like.shape and g.dtype == like.dtype
    _rel_close(got, want, 1e-5)
    # the same gradients through ops.ssd_scan's autograd Function
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm)]
    y, st = ops.ssd_scan(*leaves, chunk=chunk, return_state=True)
    loss = (y * dy).sum() + ((st * ds).sum() if with_dstate else 0.0)
    _rel_close(torch.autograd.grad(loss, leaves), want, 1e-5)


def test_ssd_scan_bwd_control_misses_the_state_gradient():
    """Without the carried state gradient the plain backward is far from
    autograd's dx at slow decay: the check that ``chip_smoke.py`` and the
    card tests make with this control can see a kernel that drops it."""
    x, dA, Bm, Cm, dy, ds = _bwd_inputs(7, 2, 96, 4, 1, 5, 6, 0.01)
    full = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=32)
    ctl = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=32, carry_state_grad=False)
    rel = ((ctl[0] - full[0]).norm() / full[0].norm()).item()
    assert rel > 1e-2


def test_ssd_scan_bwd_bf16_control_reads_above_the_limits():
    """With bf16 B and C, the plain backward from x and dy rounded to bf16
    (products of bf16 operands) is further from the fp32 one than the norm
    limits that ``chip_smoke.py`` and the card tests hold the kernel to
    (1e-4 on dx and d dA, 1e-3 on dB and dC): the check can see a kernel
    that computes in bf16."""
    x, dA, Bm, Cm, dy, _ = _bwd_inputs(5, 2, 128, 4, 1, 32, 64, 1.0)
    Bm, Cm = Bm.bfloat16(), Cm.bfloat16()
    want = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, None, chunk=64)
    ctl = ref.ssd_scan_bwd(x.bfloat16().float(), dA, Bm, Cm, dy.bfloat16().float(),
                           None, chunk=64)
    for c, w, limit in zip(ctl, want, (1e-4, 1e-4, 1e-3, 1e-3)):
        assert ((c.float() - w.float()).norm() / w.float().norm()).item() > limit


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_grads_match_jax(G):
    """The port's ``ssd_chunked`` under autograd (``ops.ssd_scan``'s Function,
    the plain backward on the CPU) against ``jax.grad`` of the JAX
    ``ssd_chunked``, with respect to xh, dt, a_log, B and C, for a random
    cotangent on y; a_log = log(0.01), so that the state carried across
    the three chunks weighs in."""
    xh, dt, a_log, Bm, Cm = _chunked_inputs(50 + G, 2, 48, 4, G, 8, 16)
    a_log = np.full_like(a_log, np.log(0.01))
    arrs = (xh, dt, a_log, Bm, Cm)
    cot = np.random.default_rng(60 + G).standard_normal(xh.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(JS.ssd_chunked(*a, chunk=16)[0] * cot)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, arrs))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, _ = S.ssd_chunked(*leaves, chunk=16)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()))


# ||got - want|| / ||want|| limits of the card checks (dx, d dA, dB, dC), by
# B/C's dtype; the kernel's split products must stay 5x under them.
SSD_NORM_LIMITS = {torch.float32: (1e-4,) * 4, torch.bfloat16: (1e-4, 1e-4, 1e-3, 1e-3)}
ROUTE = {torch.float32: "split_bc", torch.bfloat16: "bf16_bc"}
# The card's elementwise tolerances (tests/test_torch_cuda.py, chip_smoke.py):
# 10x these, d dA's atol scaled by sqrt(chunk).
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.parametrize("G,S_,chunk,tile,heads,decay,with_dstate", [
    (1, 96, 32, 8, 1, 0.01, True), (2, 64, 16, 8, 2, 1.0, False),
    (2, 96, 48, 16, 3, 0.1, True), (1, 64, 64, 64, 4, 0.01, True)])
def test_ssd_bwd_tiles_match_the_plain_backward(G, S_, chunk, tile, heads, decay, with_dstate):
    """The kernel's decomposition (tiles of ``tile`` rows, C B^T once per
    group, dB and dC summed per block of ``heads`` heads, d cum from row
    sums of M and the cross-chunk dot products), in fp32, against
    ``ref.ssd_scan_bwd`` and autograd through the plain forward."""
    x, dA, Bm, Cm, dy, ds = _bwd_inputs(70 + G + S_, 2, S_, 4, G, 5, 6, decay)
    ds = ds if with_dstate else None
    got = ref.ssd_bwd_tiles(x, dA, Bm, Cm, dy, ds, chunk=chunk, tile=tile,
                            heads_per_block=heads)
    _rel_close(got, ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk), 1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (x, dA, Bm, Cm)]
    y, st = ops.ssd_scan_plain(*leaves, chunk=chunk)
    loss = (y * dy).sum() + ((st * ds).sum() if with_dstate else 0.0)
    _rel_close(got, torch.autograd.grad(loss, leaves), 1e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_bwd_tiles_match_jax(G):
    """The decomposition's (dx, d dA, dB, dC), carried to ssd_chunked's
    inputs by the chain rule (x = xh dt, dA = dt A, A = -exp(a_log)),
    against ``jax.grad`` of the JAX ``ssd_chunked`` over three chunks of
    16 rows in tiles of 8, with the state carried across them."""
    xh, dt, a_log, Bm, Cm = _chunked_inputs(80 + G, 2, 48, 4, G, 8, 16)
    a_log = np.full_like(a_log, np.log(0.01))
    cot = np.random.default_rng(90 + G).standard_normal(xh.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(JS.ssd_chunked(*a, chunk=16)[0] * cot)

    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, (xh, dt, a_log, Bm, Cm)))
    xh_t, dt_t, Bm_t, Cm_t = map(torch.from_numpy, (xh, dt, Bm, Cm))
    A = -torch.from_numpy(a_log).exp()
    dx, ddA, dB, dC = ref.ssd_bwd_tiles(xh_t * dt_t[..., None], dt_t * A, Bm_t, Cm_t,
                                        torch.from_numpy(cot), chunk=16, tile=8,
                                        heads_per_block=2)
    got = (dx * dt_t[..., None], (dx * xh_t).sum(-1) + ddA * A,
           (ddA * dt_t * A).sum((0, 1)), dB, dC)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("B,S_,H,P,N,chunk,decay,bc", [
    (2, 128, 4, 32, 64, 64, 1.0, torch.bfloat16),
    (1, 512, 32, 64, 128, 256, 1.0, torch.bfloat16),      # the mamba2 layout at S 512
    (1, 512, 64, 64, 64, 256, 1.0, torch.bfloat16),       # the zamba2 layout at S 512
    (1, 2048, 4, 64, 128, 256, 0.01, torch.bfloat16),     # the state carried over 8 chunks
    (2, 96, 4, 5, 6, 32, 0.01, torch.float32),
    (1, 512, 8, 64, 128, 256, 0.01, torch.float32)])
def test_ssd_bwd_split_products_within_the_limits(B, S_, H, P, N, chunk, decay, bc):
    """The kernel's split products, emulated (bf16 pieces, exact products,
    fp32 sums, as ``ssd_scan.SPLIT_PIECES`` gives each product by route),
    hold each gradient 5x under the card's norm limits, and at most half
    the card's elementwise tolerances (10x TOL of the gradient's dtype; d
    dA's atol scaled by sqrt(chunk)); at the mamba2 and zamba2 layouts
    (H 32, N 128; H 64, N 64) dx, whose T1^T dy runs on two pieces, also
    within half its atol alone."""
    x, dA, Bm, Cm, dy, ds = _bwd_inputs(S_ + H + N, B, S_, H, 1, P, N, decay)
    Bm, Cm = Bm.to(bc), Cm.to(bc)
    want = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk)
    got = ref.ssd_bwd_tiles(x, dA, Bm, Cm, dy, ds, chunk=chunk, heads_per_block=2,
                            route=ROUTE[bc])
    for i, (g, w, limit) in enumerate(zip(got, want, SSD_NORM_LIMITS[bc])):
        assert _rel(g, w) <= limit / 5
        tol = 10 * CARD_TOL[g.dtype]
        atol = tol * chunk ** 0.5 if i == 1 else tol
        err = (g.float() - w.float()).abs()
        torch.testing.assert_close(g.float(), w.float(), atol=atol / 2, rtol=tol / 2)
        if i == 0 and (H, N) in ((32, 128), (64, 64)):
            assert err.max().item() <= atol / 2


@pytest.mark.parametrize("bc", [torch.float32, torch.bfloat16])
def test_ssd_bwd_two_pieces_miss_the_fp32_limits(bc):
    """Slow decay (0.003) over eight chunks with a final-state gradient: two pieces
    an operand (16 bits) for every product leave d dA (and with fp32 B/C
    dB and dC) above their elementwise fp32 tolerance, which the route's
    three-piece products keep: why dy x^T and the cross-chunk products, and
    with fp32 B/C every product, split in three. One piece (bf16 x and dy)
    misses every norm limit."""
    x, dA, Bm, Cm, dy, ds = _bwd_inputs(2048 + 4 + 128, 1, 2048, 4, 1, 64, 128, 0.003)
    Bm, Cm = Bm.to(bc), Cm.to(bc)
    want = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=256)

    def excess(got):
        return [((g.float() - w.float()).abs() - (1e-3 * 16 if i == 1 else 1e-3)
                 - 1e-3 * w.float().abs()).max().item()
                for i, (g, w) in enumerate(zip(got, want))]

    two = excess(ref.ssd_bwd_tiles(x, dA, Bm, Cm, dy, ds, chunk=256, heads_per_block=2,
                                   pieces=2))
    route = excess(ref.ssd_bwd_tiles(x, dA, Bm, Cm, dy, ds, chunk=256, heads_per_block=2,
                                     route=ROUTE[bc]))
    assert two[1] > 0 and route[1] < 0
    if bc == torch.float32:
        assert max(two[2:]) > 0 and max(route) < 0
    one = ref.ssd_bwd_tiles(x, dA, Bm, Cm, dy, ds, chunk=256, heads_per_block=2, pieces=1)
    assert all(_rel(g, w) > 1e-4 for g, w in zip(one, want))
