"""The port's training path on the CPU against the JAX package's, from one
bridged state: the synthetic data, the loss, clipping, the AdamW update from
identical gradients, the gradients of one step leaf by leaf, and whole steps
by loss and grad norm under every remat mode and with microbatches, for the
dense family and for reduced mamba2 (ssm) and zamba2 (hybrid). The kernels
run as their plain versions here (autograd Functions with the plain forward
and backward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.training import optimizer as JO
from repro.training import train as JTR
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.training import optimizer as O
from repro_torch.training import train as TR

# Reduced widths with three layers and GQA (4 query heads on 2 KV heads).
CFG_KW = dict(num_layers=3, num_kv_heads=2, param_dtype="float32",
              compute_dtype="float32")
# Reduced ssm and hybrid models: mamba2 with three layers, zamba2 with five
# (two groups of two and a leftover layer), each over sequences that its
# reduced chunk of 16 divides.
SSM_KW = {"mamba2-370m": dict(num_layers=3, param_dtype="float32", compute_dtype="float32"),
          "zamba2-1.2b": dict(num_layers=5, param_dtype="float32", compute_dtype="float32")}
SSM_SEQ = 32
# Loss and grad norm after whole steps, and the AdamW update itself: fp32
# in another summation order (relative).
STEP_RTOL = 1e-4


def _cfgs(aid="stablelm-1.6b", **kw):
    kw = {**(CFG_KW if aid == "stablelm-1.6b" else SSM_KW[aid]), **kw}
    return (reduced(get_arch(aid).model).replace(**kw),
            jreduced(jget_arch(aid).model).replace(**kw))


def _seq(aid):
    return 24 if aid == "stablelm-1.6b" else SSM_SEQ


ARCHS = pytest.mark.parametrize("aid", ["stablelm-1.6b", "mamba2-370m", "zamba2-1.2b"],
                                ids=["stablelm", "mamba2", "zamba2"])


def _tcfgs(**kw):
    kw = {"optimizer": "adamw", "learning_rate": 3e-4, "weight_decay": 0.1,
          "grad_clip": 1.0, **kw}
    return TrainConfig(**kw), JTrainConfig(**kw)


def _bridged(cfg, jcfg, jtcfg, seed=0):
    jstate = JTR.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(seed))
    np_state = jax.tree.map(np.asarray, jstate)
    return jstate, bridge.state_from_jax(np_state, cfg, "cpu")


def _batches(n, batch=2, seq=24, vocab=512, seed=0):
    return list(pipeline.synthetic_batches(batch, seq, vocab, seed=seed, n=n))


@pytest.mark.parametrize("batch,seq,vocab,seed", [(2, 16, 512, 0), (3, 40, 100, 7)])
def test_synthetic_batches_copy_equals_the_original(batch, seq, vocab, seed):
    ours = list(pipeline.synthetic_batches(batch, seq, vocab, seed=seed, n=3))
    theirs = list(jpipe.synthetic_batches(batch, seq, vocab, seed=seed, n=3))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    targets = rng.integers(0, 48, (2, 7)).astype(np.int32)
    want = JTR.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = TR.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    jclipped, jnorm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    clipped, norm = O.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(O.global_norm(clipped.values()).item(),
                               min(max_norm, float(jnorm)), rtol=1e-5)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]),
                                   rtol=1e-6, atol=1e-7)


def test_clip_keeps_each_gradients_dtype():
    grads = {"w": torch.ones(4, dtype=torch.bfloat16) * 10, "b": torch.ones(2)}
    clipped, norm = O.clip_by_global_norm(grads, 1.0)
    assert clipped["w"].dtype == torch.bfloat16 and clipped["b"].dtype == torch.float32
    assert norm.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """The update from identical gradients and moments, after some steps
    (count 3), for fp32 and bf16 params: new params, mu, nu and count."""
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "s": (5,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mu = {k: 0.1 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    nu = {k: 0.1 * np.abs(rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p.items()}
    jstate = {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
              "count": jnp.asarray(3, jnp.int32)}
    jnew, jopt = JO.adamw_update(jax.tree.map(jnp.asarray, g), jstate, jp,
                                 lr=3e-4, weight_decay=0.1)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    tstate = {"mu": {k: torch.from_numpy(v) for k, v in mu.items()},
              "nu": {k: torch.from_numpy(v) for k, v in nu.items()},
              "count": torch.tensor(3, dtype=torch.int32)}
    tnew, topt = O.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                tstate, tp, lr=3e-4, weight_decay=0.1)
    assert int(topt["count"]) == int(jopt["count"]) == 4
    for k in shapes:
        assert tnew[k].dtype == tdt
        np.testing.assert_allclose(tnew[k].float().numpy(),
                                   np.asarray(jnew[k].astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-7)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(topt[m][k].numpy(), np.asarray(jopt[m][k]),
                                       rtol=1e-6, atol=1e-9)


def test_adamw_init_fp32_moments_and_adafactor_waits():
    """AdamW's moments are fp32 for bf16 params; Adafactor's state follows
    the JAX leaves: vr/vc for a factored leaf (its layers stacked), v for
    an unfactored one, fp32, keyed by JAX path (tests/test_torch_moe.py
    holds the update to JAX's)."""
    params = {"w": torch.zeros(3, 2, dtype=torch.bfloat16)}
    st = O.opt_init("adamw")(params)
    assert st["mu"]["w"].dtype == torch.float32 and st["count"].dtype == torch.int32
    params = {"w": torch.zeros(3, 2, dtype=torch.bfloat16), "b": torch.zeros(4),
              "layers.0.s": torch.zeros(5), "layers.1.s": torch.zeros(5)}
    st = O.opt_init("adafactor")(params)
    shapes = {m: {k: tuple(v.shape) for k, v in st[m].items()} for m in ("vr", "vc", "v")}
    assert shapes == {"vr": {"w": (3,), "b": (1,), "layers/s": (2,)},
                      "vc": {"w": (2,), "b": (1,), "layers/s": (5,)},
                      "v": {"w": (1,), "b": (4,), "layers/s": (1,)}}
    assert all(v.dtype == torch.float32 for m in ("vr", "vc", "v") for v in st[m].values())
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0


def test_bridged_state_round_trips():
    cfg, jcfg = _cfgs()
    _, jtcfg = _tcfgs()
    jstate, state = _bridged(cfg, jcfg, jtcfg)
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["step"].dtype == torch.int32 and state["opt"]["count"].dtype == torch.int32
    src = bridge.flatten(jax.tree.map(np.asarray, jstate))
    back = bridge.flatten(bridge.state_to_numpy(state))
    assert src.keys() == back.keys()
    for k in src:
        np.testing.assert_array_equal(back[k], src[k], k)


@ARCHS
def test_one_step_grads_match_jax_leaf_by_leaf(aid):
    """Gradients of the loss from one bridged state, each leaf within 1e-4
    of that leaf's largest JAX gradient."""
    cfg, jcfg = _cfgs(aid)
    tcfg, jtcfg = _tcfgs()
    jstate, state = _bridged(cfg, jcfg, jtcfg)
    batch = _batches(1, seq=_seq(aid))[0]
    jgrads = jax.grad(lambda p: JTR.make_loss_fn(jcfg, jtcfg)(p, batch)[0])(
        jstate["params"])
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    loss, _ = TR.make_loss_fn(cfg, tcfg)(params, TR.to_device(batch, "cpu"))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = bridge.flatten(jax.tree.map(np.asarray, jgrads))
    got = bridge.flatten(bridge.unflatten(
        {k: v.numpy() for k, v in bridge._stacked(grads.items()).items()}))
    assert want.keys() == got.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("aid,remat,accum", [
    *(pytest.param("stablelm-1.6b", r, a, id=f"{a}-{r}")
      for a in (1, 2) for r in ("none", "full", "dots")),
    *(pytest.param(aid, r, 1, id=f"{aid.split('-')[0]}-{r}")
      for aid in ("mamba2-370m", "zamba2-1.2b") for r in ("none", "full"))])
def test_three_steps_match_jax(aid, remat, accum):
    """Loss and grad norm of three whole steps (AdamW, clipping) on the JAX
    package's data, from one bridged state."""
    cfg, jcfg = _cfgs(aid)
    tcfg, jtcfg = _tcfgs(remat=remat, accum_steps=accum)
    jstate, state = _bridged(cfg, jcfg, jtcfg)
    jstep = jax.jit(JTR.make_train_step(jcfg, jtcfg))
    step = TR.make_train_step(cfg, tcfg)
    for batch in _batches(3, batch=4, seq=_seq(aid)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, TR.to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
    assert int(state["step"]) == int(jstate["step"]) == 3


@ARCHS
def test_remat_modes_give_equal_grads(aid):
    cfg, _ = _cfgs(aid)
    batch = TR.to_device(_batches(1, seq=_seq(aid))[0], "cpu")
    grads = {}
    for remat in ("none", "full", "dots"):
        tcfg, _ = _tcfgs(remat=remat)
        params = TR.init_train_state(cfg, tcfg, 3, device="cpu")["params"]
        loss, _ = TR.make_loss_fn(cfg, tcfg)(params, batch)
        grads[remat] = torch.autograd.grad(loss, list(params.parameters()))
    for remat in ("full", "dots"):
        for a, b in zip(grads["none"], grads[remat]):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_remat_recomputes_what_its_policy_drops():
    """Matrix products (``aten.mm``) run in a forward and backward: "full"
    runs each layer's products again in the recompute, all but the MLP's
    down projection (q, k, v, o, gate, up: the recompute stops once the last
    input the backward needs exists); "dots" keeps their outputs, so it runs
    as many as "none"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    cfg, _ = _cfgs()
    batch = TR.to_device(_batches(1)[0], "cpu")
    counts = {}
    for remat in ("none", "full", "dots"):
        tcfg, _ = _tcfgs(remat=remat)
        params = TR.init_train_state(cfg, tcfg, 3, device="cpu")["params"]
        CountMM.n = 0
        with CountMM():
            loss, _ = TR.make_loss_fn(cfg, tcfg)(params, batch)
            torch.autograd.grad(loss, list(params.parameters()))
        counts[remat] = CountMM.n
    assert counts["dots"] == counts["none"]
    assert counts["full"] - counts["none"] == 6 * cfg.num_layers


def test_bad_remat_mode_raises():
    cfg, _ = _cfgs()
    tcfg, _ = _tcfgs(remat="everything")
    params = TR.init_train_state(cfg, tcfg, 0, device="cpu")["params"]
    with pytest.raises(ValueError, match="remat"):
        TR.make_loss_fn(cfg, tcfg)(params, TR.to_device(_batches(1)[0], "cpu"))


def test_eval_step_matches_jax():
    cfg, jcfg = _cfgs()
    tcfg, jtcfg = _tcfgs()
    jstate, state = _bridged(cfg, jcfg, jtcfg)
    batch = _batches(1, seed=5)[0]
    want = JTR.make_eval_step(jcfg, jtcfg)(jstate["params"], batch)["loss"]
    got = TR.make_eval_step(cfg, tcfg)(state["params"], TR.to_device(batch, "cpu"))["loss"]
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("aid,remat,want", [
    ("stablelm-1.6b", "full", {"flash_attention": 48, "flash_attention_bwd": 24,
                               "rmsnorm": 97, "rmsnorm_bwd": 49}),
    ("mamba2-370m", "full", {"ssd_scan": 96, "ssd_scan_bwd": 48,
                             "rmsnorm": 193, "rmsnorm_bwd": 97}),
    ("mamba2-370m", "none", {"ssd_scan": 48, "ssd_scan_bwd": 48,
                             "rmsnorm": 97, "rmsnorm_bwd": 97}),
    ("zamba2-1.2b", "full", {"ssd_scan": 76, "ssd_scan_bwd": 38, "flash_attention": 6,
                             "flash_attention_bwd": 6, "rmsnorm": 165, "rmsnorm_bwd": 89})])
def test_kernel_launches_per_step_at_full_width(aid, remat, want):
    """The launch rule of a train step at the archs' own depths: under remat
    "full" each layer's forward kernels run twice, the final norm and
    zamba2's six shared blocks once; every kernel it does not name is 0."""
    got = TR.kernel_launches_per_step(get_arch(aid).model, remat)
    assert got == {**{name: 0 for name in got}, **want}
    assert set(got) == {"flash_attention", "flash_attention_bwd", "rmsnorm",
                        "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd"}


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg, _ = _cfgs()
    tcfg, _ = _tcfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        TR.init_train_state(cfg, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TR.to_device(_batches(1)[0])


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-every", "1",
            "--log-every", "1", "--ckpt-dir", str(tmp_path), "--device", "cpu",
            "--reduced"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done at step 2" in out
    launch_train.main(args[:1] + ["3"] + args[2:])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out and "done at step 3" in out


def test_launch_train_ssm_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """The reduced mamba2 through the launcher: its train steps (the ssd_scan
    backward as the plain version), checkpoints and a resume."""
    args = ["--arch", "mamba2-370m", "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done at step 2" in out
    launch_train.main(args[:3] + ["3"] + args[4:])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out and "done at step 3" in out


def test_launch_train_defaults_to_the_reduced_config():
    assert launch_train.parser().parse_args([]).full is False
    assert launch_train.parser().parse_args(["--reduced"]).full is False
    assert launch_train.parser().parse_args(["--full"]).full is True


def test_launch_train_reduced_and_full_exclude_each_other(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--reduced", "--full", "--device", "cpu"])
    assert "not allowed with argument" in capsys.readouterr().err


def test_launch_train_configs():
    cfg, tcfg = launch_train.configs("stablelm-1.6b", full=True)
    assert (cfg.num_layers, cfg.d_model, cfg.param_dtype) == (24, 2048, "bfloat16")
    assert (tcfg.remat, tcfg.learning_rate, tcfg.accum_steps) == ("full", 3e-4, 1)
    cfg, tcfg = launch_train.configs("stablelm-1.6b", full=False)
    assert cfg.param_dtype == "float32" and tcfg.remat == "none"
    assert tcfg.learning_rate == 1e-3
    for aid, n in (("mamba2-370m", 48), ("zamba2-1.2b", 38)):
        cfg, tcfg = launch_train.configs(aid, full=True)
        assert (cfg.num_layers, cfg.ssm_chunk, cfg.param_dtype) == (n, 256, "bfloat16")
        assert (tcfg.optimizer, tcfg.remat, tcfg.accum_steps) == ("adamw", "full", 1)
