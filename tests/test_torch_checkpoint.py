"""The port's checkpoints against the JAX package's, both ways: the same
on-disk layout (one ``.npy`` per leaf of the stacked JAX tree and a
manifest), a JAX checkpoint restoring into the port and training on to
JAX's losses, a port checkpoint restoring into JAX leaf for leaf, and bf16
leaves round-tripping in the port."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.training import train as JTR
from repro.training.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import pipeline
from repro_torch.training import train as TR
from repro_torch.training.checkpoint import CheckpointManager, StepCheckpointSession

CFG_KW = dict(num_layers=3, num_kv_heads=2)
TCFG_KW = dict(optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip=1.0)


def _cfgs(dtype="float32"):
    kw = dict(CFG_KW, param_dtype=dtype, compute_dtype=dtype)
    return (reduced(get_arch("stablelm-1.6b").model).replace(**kw),
            jreduced(jget_arch("stablelm-1.6b").model).replace(**kw))


def _batches(n, seed=0):
    return list(pipeline.synthetic_batches(2, 24, 512, seed=seed, n=n))


def _jax_state(jcfg, seed=0):
    return JTR.init_train_state(jcfg, JTrainConfig(**TCFG_KW), jax.random.PRNGKey(seed))


def _jax_steps(jcfg, jstate, batches):
    step = jax.jit(JTR.make_train_step(jcfg, JTrainConfig(**TCFG_KW)))
    losses = []
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return jstate, losses


def _port_steps(cfg, state, batches):
    step = TR.make_train_step(cfg, TrainConfig(**TCFG_KW))
    losses = []
    for b in batches:
        state, m = step(state, TR.to_device(b, "cpu"))
        losses.append(m["loss"].item())
    return state, losses


def test_jax_checkpoint_restores_into_the_port_and_trains_on(tmp_path):
    """JAX trains 3 steps and saves; the port restores the checkpoint (as a
    fresh state, and into an existing one in place) and its next 2 losses
    are JAX's."""
    cfg, jcfg = _cfgs()
    batches = _batches(5)
    jstate, _ = _jax_steps(jcfg, _jax_state(jcfg), batches[:3])
    JCheckpointManager(str(tmp_path)).save(3, jstate)

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    flat = mgr.restore()
    assert flat["step"].dtype == torch.int32 and int(flat["step"]) == 3
    state = bridge.state_from_jax(bridge.unflatten(flat), cfg, "cpu")
    in_place = mgr.restore(like=TR.init_train_state(cfg, TrainConfig(**TCFG_KW), 9,
                                                    device="cpu"))
    _, jlosses = _jax_steps(jcfg, jstate, batches[3:])
    for st in (state, in_place):
        assert int(st["step"]) == 3 and int(st["opt"]["count"]) == 3
        st, losses = _port_steps(cfg, st, batches[3:])
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        assert int(st["step"]) == 5


def test_port_checkpoint_restores_into_jax_leaf_for_leaf(tmp_path):
    cfg, jcfg = _cfgs()
    jstate = _jax_state(jcfg)
    state = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    state, _ = _port_steps(cfg, state, _batches(2))
    CheckpointManager(str(tmp_path)).save(2, state)

    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.latest_step() == 2
    restored = jmgr.restore(like=jax.tree.map(np.asarray, jstate))
    want = bridge.flatten(bridge.state_to_numpy(state))
    got = bridge.flatten(restored)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], k)
    # the same files and manifest entries as a JAX save of a JAX state
    JCheckpointManager(str(tmp_path / "jax")).save(0, jstate)
    ours = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "step_00000000" / "manifest.json").read_text())
    assert ours["leaves"] == theirs["leaves"]


def test_bf16_round_trip_in_the_port(tmp_path):
    cfg, _ = _cfgs("bfloat16")
    tcfg = TrainConfig(**TCFG_KW)
    state, _ = _port_steps(cfg, TR.init_train_state(cfg, tcfg, 1, device="cpu"),
                           _batches(1))
    mgr = CheckpointManager(str(tmp_path))
    d = mgr.save(1, state)
    manifest = {m["path"]: m for m in json.loads((d / "manifest.json").read_text())["leaves"]}
    leaf = manifest["params/layers/attn/wq"]
    assert leaf["dtype"] == "bfloat16"
    assert np.load(d / leaf["file"]).dtype == np.dtype("V2")   # as JAX's np.save writes it
    assert manifest["opt/mu/layers/attn/wq"]["dtype"] == "float32"
    fresh = mgr.restore(like=TR.init_train_state(cfg, tcfg, 2, device="cpu"))
    for (n1, p1), (n2, p2) in zip(state["params"].named_parameters(),
                                  fresh["params"].named_parameters()):
        assert n1 == n2 and p2.dtype == torch.bfloat16 and torch.equal(p1, p2)
    for m in ("mu", "nu"):
        for k, t in state["opt"][m].items():
            assert torch.equal(fresh["opt"][m][k], t)
    assert int(fresh["step"]) == 1


def test_jax_bf16_checkpoint_restores_into_the_port(tmp_path):
    """A bf16 checkpoint written by the JAX package, which the JAX package
    cannot restore itself, restores into the port exactly."""
    cfg, jcfg = _cfgs("bfloat16")
    jstate = _jax_state(jcfg)
    JCheckpointManager(str(tmp_path)).save(0, jstate)
    flat = CheckpointManager(str(tmp_path)).restore()
    assert flat["params/embed/table"].dtype == torch.bfloat16
    state = bridge.state_from_jax(bridge.unflatten(flat), cfg, "cpu")
    want = bridge.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                       if a.dtype == jnp.bfloat16 else np.asarray(a), jstate))
    got = bridge.flatten(bridge.state_to_numpy(state))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_async_save_snapshots_before_later_updates(tmp_path):
    cfg, _ = _cfgs()
    tcfg = TrainConfig(**TCFG_KW)
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    before = state["params"]["final_norm"]["scale"].detach().clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.async_save(0, state)
    state, _ = _port_steps(cfg, state, _batches(1))   # updates the params in place
    mgr.wait()
    assert torch.equal(mgr.restore(0)["params/final_norm/scale"], before)
    assert not torch.equal(state["params"]["final_norm"]["scale"].detach(), before)


def test_gc_keeps_the_newest_and_offers_to_a_cache(tmp_path):
    offers = []

    class Cache:
        def offer(self, key, value, **kw):
            offers.append((key, value, kw["nbytes"]))

    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, cache=Cache())
    for step in (1, 2, 3):
        mgr.save(step, {"w": np.full((3,), step, np.float32), "step": np.int32(step)})
    assert sorted(p.name for p in (tmp_path / "run").glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    assert [o[0] for o in offers] == ["ckpt:run:1", "ckpt:run:2", "ckpt:run:3"]
    assert all(o[2] > 0 for o in offers)
    assert mgr.save(3, {"w": np.zeros(3, np.float32)}).name == "step_00000003"  # idempotent
    np.testing.assert_array_equal(mgr.restore()["w"].numpy(), np.full((3,), 3, np.float32))


def test_step_checkpoint_session(tmp_path):
    ticks = []
    sess = StepCheckpointSession(CheckpointManager(str(tmp_path)), on_tick=ticks.append)
    assert sess.latest_step() is None
    with pytest.raises(FileNotFoundError):
        sess.restore()
    sess.save(4, {"x": np.arange(3, dtype=np.int32)})
    sess.tick(5)
    assert ticks == [4, 5]
    out = sess.restore()
    assert sess.resumed_from == 4 and out["x"].tolist() == [0, 1, 2]
