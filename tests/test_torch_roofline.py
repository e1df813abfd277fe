"""The port's roofline module (``repro_torch/roofline/analysis.py``) against
the JAX package's (``repro/roofline/analysis.py``): ``model_flops`` and
``roofline_report`` on the same terms for every arch x LM shape, the kernel
formulas that ``chip_smoke.py``'s ``bound_ms`` reads at PERF.md's main-path
shapes, and ``count_step`` on fake tensors against ``analyze_hlo`` of JAX's
compiled train step."""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import mesh as jmesh
from repro.roofline import analysis as JA
from repro.training import train as JTR
from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import LM_SHAPES, ShapeConfig
from repro_torch.launch.specs import input_specs
from repro_torch.roofline import analysis as RF
from repro_torch.training import train as TR

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _terms(mod):
    return mod.RooflineTerms(flops=3.5e15, coll_bytes=2.0e11, coll_f32_bytes=6.0e10,
                             hbm_bytes=4.0e12, coll_by_kind={"all-reduce": 2.0e11},
                             compute_s=0.9, memory_s=1.3, collective_s=0.7,
                             collective_s_bf16=0.6, dominant="memory")


@pytest.mark.parametrize("shape", [s.name for s in LM_SHAPES])
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_model_flops_and_report_equal_jax(arch, shape):
    """The same formulas on the same terms: every key equal, but the two
    that divide by the peak, which scale by JAX's peak over the port's."""
    cfg, jc = configs.get_arch(arch).model, jcfg.get_arch(arch).model
    sh, jsh = configs.base.SHAPES_BY_NAME[shape], jcfg.get_shape(shape)
    n = cfg.param_counts()["active"]
    assert n == jc.param_counts()["active"]
    assert RF.model_flops(cfg, sh, n) == JA.model_flops(jc, jsh, n)
    got = RF.roofline_report(_terms(RF), cfg, sh, 256)
    want = JA.roofline_report(_terms(JA), jc, jsh, 256)
    assert got.keys() == want.keys()
    ratio = jmesh.PEAK_FLOPS / RF.PEAK_FLOPS
    for key in want:
        if key in ("model_compute_s", "roofline_fraction"):
            assert got[key] == pytest.approx(want[key] * ratio, rel=1e-12)
        else:
            assert got[key] == want[key], key


def test_measured_report_adds_mfu_and_bound_fraction():
    cfg = configs.get_arch("stablelm-1.6b").model
    rep = RF.roofline_report(_terms(RF), cfg, configs.base.SHAPES_BY_NAME["train_4k"], 256)
    got = RF.measured_report(rep, 2.6)
    assert got["measured_s"] == 2.6
    assert got["mfu"] == pytest.approx(rep["model_flops_per_chip"] / (2.6 * 989e12))
    assert got["bound_fraction"] == pytest.approx(1.3 / 2.6)


# PERF.md section 6's main-path cases: (kernel, fields, bound_ms, bound_by)
BOUND_CASES = [
    ("rmsnorm", dict(R=4, D=2048, dtype="bfloat16", scale_dtype="bfloat16"),
     0.000011, "bytes"),
    ("flash_attention", dict(B=4, H=32, KH=32, Sq=128, Sk=128, D=64, Dv=64,
                             dtype="bfloat16", causal=True, prefix_len=0, lse=False),
     0.00250, "bytes"),
    ("ssd_scan", dict(B=4, S=1024, H=32, G=1, P=64, N=128, chunk=256,
                      bc_dtype="bfloat16", x_bytes=4), 0.0208, "bytes"),
    ("rmsnorm_bwd", dict(R=8192, D=2048, dtype="bfloat16", scale_dtype="bfloat16"),
     0.0301, "bytes"),
    ("flash_attention_bwd", dict(B=2, H=32, KH=32, Sq=4096, Sk=4096, D=64, Dv=64,
                                 dtype="bfloat16", causal=True, prefix_len=0),
     0.348, "operations"),
    ("ssd_scan_bwd", dict(B=2, S=4096, H=32, G=1, P=64, N=128, chunk=256,
                          bc_dtype="bfloat16", dstate=False), 0.1045, "operations")]


@pytest.mark.parametrize("kernel,fields,want_ms,want_by", BOUND_CASES,
                         ids=[c[0] for c in BOUND_CASES])
def test_kernel_bounds_at_the_main_path_shapes(kernel, fields, want_ms, want_by):
    """The formulas moved out of chip_smoke.py give the bound_ms that
    PERF.md's kernel table reports (to its rounding)."""
    ms, by = RF.bound(*RF.kernel_work(kernel, fields)[:2])
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=0.02)


def test_valid_pairs_of_the_prefix_mask():
    assert RF.valid_pairs(5, 5, False) == 25
    assert RF.valid_pairs(5, 5, True) == 15
    assert RF.valid_pairs(5, 5, True, prefix=3) == 3 + 3 + 3 + 4 + 5


def test_step_flops_count_every_padded_key_block():
    """The attention's terms as JAX's blockwise attention does them: keys
    padded to whole blocks of 1024 (4352 -> 5120), no mask skipped, 2
    products forward and 6 backward; the scan's four einsums, twice back."""
    f = dict(B=2, H=8, KH=1, Sq=4352, Sk=4352, D=256, Dv=256, dtype="bfloat16",
             causal=True, prefix_len=256)
    fwd = 2.0 * 2 * 8 * 4352 * 5120 * 512
    assert RF.step_flops("flash_attention", f) == fwd
    assert RF.step_flops("flash_attention_bwd", f) == 3 * fwd
    s = dict(B=1, S=512, H=4, G=1, P=16, N=8, chunk=64, bc_dtype="float32")
    per = 2.0 * 512 * 4 * (64 * 8 + 64 * 16 + 2 * 8 * 16)
    assert RF.step_flops("ssd_scan", s) == per
    assert RF.step_flops("ssd_scan_bwd", s) == 2 * per
    assert RF.step_flops("rmsnorm", dict(R=4, D=8)) == 0.0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-370m"])
def test_count_step_matches_analyze_hlo(arch):
    """A reduced train step (fp32, remat none, (2, 64)): ``count_step`` on
    fake tensors against ``analyze_hlo`` of JAX's compiled step, within 2%
    on the flops. The terms that differ, and why: ``hbm_bytes`` (JAX's proxy
    sums every dot's operand and result bytes, the attention's score
    blocks and the scan's chunk products included; the port counts the
    products' bytes and each fused kernel's own reads and writes); no
    collective on either side at one device."""
    kw = dict(optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip=1.0,
              remat="none")
    cfg = configs.reduced(configs.get_arch(arch).model).replace(**F32)
    jc = jcfg.reduced(jcfg.get_arch(arch).model).replace(**F32)
    jtcfg = JTrainConfig(**kw)
    B, S = 2, 64
    jstate = JTR.init_train_state(jc, jtcfg, jax.random.PRNGKey(0))
    jbatch = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "targets")}
    want = JA.analyze_hlo(jax.jit(JTR.make_train_step(jc, jtcfg))
                          .lower(jstate, jbatch).compile().as_text())
    with FakeTensorMode():
        state = TR.init_train_state(cfg, TrainConfig(**kw), 0, device="cpu")
        counter = RF.StepCounter()
        got = RF.count_step(TR.make_train_step(cfg, TrainConfig(**kw)), state,
                            input_specs(cfg, ShapeConfig("t", S, B, "train")),
                            counter=counter)
    assert got.flops == pytest.approx(want.flops, rel=0.02)
    assert got.coll_bytes == want.coll_bytes == 0
    kernels = {name for name, _ in counter.kernels}
    assert kernels >= {"rmsnorm", "rmsnorm_bwd"}
    assert counter.aten_ops > 0 and got.dominant in ("compute", "memory")


def test_count_step_launches_nothing_and_refuses_real_tensors():
    """Inside the count every kernel is planned on fake tensors, none is
    launched and nothing is counted in LAUNCHES; a real tensor raises."""
    from repro_torch.kernels import ops
    cfg = configs.reduced(configs.get_arch("paligemma-3b").model).replace(**F32)
    tcfg = TrainConfig(optimizer="adamw", remat="full")
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
        counter = RF.StepCounter()
        RF.count_step(TR.make_train_step(cfg, tcfg), state,
                      input_specs(cfg, ShapeConfig("t", 16, 2, "train")), counter=counter)
    assert ops.LAUNCHES == before
    counts = {}
    for name, _ in counter.kernels:
        counts[name] = counts.get(name, 0) + 1
    expect = TR.kernel_launches_per_step(cfg, "full")
    assert counts == {k: v for k, v in expect.items() if v}
    x = torch.zeros(4, 8)
    with ops.dry_run(), pytest.raises(RuntimeError, match="fake tensors only"):
        ops.rmsnorm(x, torch.ones(8))


def _fake_cuda_calls():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    bf, f32 = torch.bfloat16, torch.float32

    def e(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device="cuda")
    x, s = e(8, 64, dtype=bf), e(64, dtype=bf)
    q = e(1, 2, 64, 64, dtype=bf)
    xs, dA, bc = e(1, 64, 2, 16), e(1, 64, 2), e(1, 64, 1, 16)
    return {
        "rmsnorm": lambda: ops.rmsnorm(x, s),
        "rmsnorm_bwd": lambda: rn.rmsnorm_bwd_cuda(x, s, x),
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd_cuda(
            q, q, q, q, e(1, 2, 64), q),
        "ssd_scan": lambda: ops.ssd_scan(xs, dA, bc, bc, chunk=32),
        "ssd_scan_bwd": lambda: ss.ssd_scan_bwd_cuda(
            xs, dA, bc, bc, 32, e(1, 2, 64, dtype=torch.float64), e(1, 2, 2, 16, 16),
            None, xs, None),
    }


@pytest.mark.parametrize("kernel", ["rmsnorm", "rmsnorm_bwd", "flash_attention",
                                    "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"])
def test_fake_card_tensor_outside_a_dry_run_raises_and_counts_nothing(kernel):
    """Outside ``ops.dry_run()`` a fake tensor on the card's device reaches
    the launcher, which raises before any count moves: no empty output
    stands for a launch that never ran."""
    from repro_torch.kernels import ops
    with FakeTensorMode():
        call = _fake_cuda_calls()[kernel]
        before = dict(ops.LAUNCHES)
        with pytest.raises(RuntimeError, match="outside ops.dry_run"):
            call()
    assert ops.LAUNCHES == before
