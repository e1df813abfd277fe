"""The frozen counts against numbers worked by hand."""
import json
from pathlib import Path

import pytest

from portbench import work

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("Sq,Sk,prefix", [(1, 1, 0), (5, 5, 0), (7, 3, 0), (3, 7, 0),
                                          (6, 6, 2), (4096, 4096, 0)])
def test_valid_pairs_against_the_row_sum(Sq, Sk, prefix):
    want = sum(min(Sk, max(i + 1, prefix)) for i in range(Sq))
    assert work.valid_pairs(Sq, Sk, True, prefix) == want
    assert work.valid_pairs(Sq, Sk, False) == Sq * Sk


def test_flash_work_by_hand():
    f = dict(B=2, H=4, KH=2, Sq=8, Sk=8, D=16, Dv=16, dtype="bfloat16", causal=True,
             prefix_len=0, lse=True)
    nbytes, ops_s = work.kernel_work("flash_attention", f)
    # q, o: 2*4*8*16 each; k, v: 2*2*8*16 each; 2 bytes; lse 4 bytes a row
    assert nbytes == (1024 + 512 + 512 + 1024) * 2 + 4 * 64
    assert ops_s == pytest.approx(2 * 2 * 4 * 36 * 32 / 989e12)
    nbytes, ops_s = work.kernel_work("flash_attention_bwd", f)
    assert nbytes == (2 * 1024 + 2 * 512 + 2 * 512 + 2 * 1024) * 2 + 4 * 64
    assert ops_s == pytest.approx(2 * 2 * 4 * 36 * (3 * 16 + 2 * 16) / 989e12)


def test_ssd_work_by_hand():
    f = dict(B=1, S=512, H=2, G=1, P=64, N=64, chunk=256, bc_dtype="bfloat16", x_bytes=4,
             dstate=False)
    nbytes, ops_s = work.kernel_work("ssd_scan", f)
    x = 512 * 2 * 64
    assert nbytes == 2 * x * 4 + 4 * 512 * 2 + 2 * 512 * 64 * 2
    rows = 2 * 512
    recurrence = 5 * rows * 64 * 64 / 67e12
    chunked = rows * (256 * 64 / 2 / 989e12 + (256 * 64 + 4 * 64 * 64) / 67e12)
    tensor_cores = rows * (256 * 64 / 2 * 1 + 256 * 64 * 3 + 4 * 64 * 64 * 2) / 989e12
    assert ops_s == pytest.approx(min(recurrence, chunked, tensor_cores))


def test_product_work_by_hand():
    flops, t = work.product_work("aten::mm", [[8192, 2048], [2048, 5632]])
    assert flops == 2 * 8192 * 2048 * 5632
    assert t == pytest.approx(flops / 989e12)
    flops, t = work.product_work("aten::addmm", [[64], [4, 3], [3, 64], [], []])
    assert flops == 2 * 4 * 3 * 64
    assert t == pytest.approx((4 * 3 + 3 * 64 + 4 * 64) * 2 / 3.35e12)


def test_stablelm_step_by_hand():
    m = json.loads((ROOT / "portbench/configs/stablelm-1.6b.json").read_text())["model"]
    T, D, F, V, L = 8192, 2048, 5632, 100352, 24
    per_layer = 8 * T * D * D + 6 * T * D * F + 2 * 2 * 32 * (4096 * 4097 // 2) * 128
    want = 3 * (L * per_layer + 2 * T * D * V)
    assert work.model_flops_per_step(m, 2, 4096, 1) == pytest.approx(want)
    assert work.model_flops_per_step(m, 2, 4096, 8) == pytest.approx(8 * want)
    assert want == pytest.approx(80.61e12, rel=1e-3)


def test_zamba2_step_by_hand():
    m = json.loads((ROOT / "portbench/configs/zamba2-1.2b.json").read_text())["model"]
    T, D, V = 8 * 4096, 2048, 32000
    ssm = 2 * T * D * (2 * 4096 + 2 * 64 + 64) + 2 * T * 4096 * D + 2 * T * 64 * (
        256 * 64 + 256 * 64 + 2 * 64 * 64)
    attn = 2 * T * 4096 * 3 * 4096 + 2 * T * 4096 * D + 2 * 8 * 32 * (4096 * 4097 // 2) * 256
    shared = attn + 2 * 2 * T * 4096 * 8192 + 2 * T * 8192 * D
    want = 3 * (2 * T * D * V + 38 * ssm + 6 * shared)
    assert work.model_flops_per_step(m, 8, 4096, 1) == pytest.approx(want)


def test_ssm_and_gelu_steps_by_hand():
    m = json.loads((ROOT / "portbench/configs/zamba2-1.2b.json").read_text())["model"]
    m = dict(m, family="ssm", num_layers=48, d_model=1024, vocab_size=50280,
             pad_vocab_multiple=16)
    T, D, V = 2 * 4096, 1024, 50288
    # d_in 2048, 32 heads of 64, one group of state 64, chunks of 256
    ssm = 2 * T * D * (2 * 2048 + 2 * 64 + 32) + 2 * T * 2048 * D + 2 * T * 32 * (
        256 * 64 + 256 * 64 + 2 * 64 * 64)
    assert work.model_flops_per_step(m, 2, 4096, 1) == pytest.approx(
        3 * (2 * T * D * V + 48 * ssm))
    s = json.loads((ROOT / "portbench/configs/stablelm-1.6b.json").read_text())["model"]
    T, D, F, V = 8192, 2048, 5632, 100352
    gated = work.forward_products(s, 2, 4096)
    plain = work.forward_products(dict(s, act="gelu"), 2, 4096)
    assert gated - plain == pytest.approx(24 * 2 * T * D * F)
    assert work.forward_products(dict(s, act="geglu"), 2, 4096) == gated


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_each_family_is_a_file_found_by_name(family):
    from portbench import families
    mod = families.load(family)
    assert callable(mod.body) and callable(mod.forward_products)


def test_a_family_without_a_file_is_refused():
    from portbench import families
    m = json.loads((ROOT / "portbench/configs/stablelm-1.6b.json").read_text())["model"]
    with pytest.raises(ValueError, match="families/moe.py"):
        work.forward_products(dict(m, family="moe"), 1, 16)
    with pytest.raises(ValueError, match="families/moe.py"):
        families.load("moe")
