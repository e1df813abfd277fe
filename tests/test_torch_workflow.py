"""The port's Couler workflow layer (``repro_torch.core``) against the JAX
package's (``repro.core``), on the CPU at a small size.

``repro_torch.core`` is a scripted copy of ``repro.core`` with the package
prefix rewritten (``scripts/port_core.py``); the copy differs only in the
torch seams of ``engines/local.py``, in ``autotune.train_real_model`` and
in the nondeterminism pass's view of torch's global generator
(``analysis/ndet.py``).
Workflows of both packages run here with their own payloads, the port's
started from JAX's init, bridged."""
import dataclasses
import importlib.util
import random
import time
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core import autotune as JA
from repro.core import couler as jcouler
from repro.core.analysis import lint as jlint, nondeterminism_findings as jfindings
from repro.core.caching import CacheStore as JCacheStore, CoulerPolicy as JCoulerPolicy
from repro.core.engines import local as JL
from repro.core.engines.base import StepStatus as JStepStatus
from repro.data import pipeline as jpipe
from repro.training import train as JTR
from repro_torch import bridge
from repro_torch.configs import get_arch, reduced
from repro_torch.core import autotune as A
from repro_torch.core import couler
from repro_torch.core.analysis import lint, nondeterminism_findings as findings
from repro_torch.core.caching import CacheStore, CoulerPolicy
from repro_torch.core.engines import local as L
from repro_torch.core.engines.base import StepStatus
from repro_torch.core.faults import FaultPlan
from repro_torch.core.ir import Job, WorkflowIR
from repro_torch.data import pipeline
from repro_torch.training import train as TR

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("port_core", ROOT / "scripts" / "port_core.py")
port_core = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(port_core)

# Loss after whole steps: fp32 in another summation order (relative), as
# tests/test_torch_train.py holds the train step.
STEP_RTOL = 1e-4

ORIGINAL_FILES = sorted(p.relative_to(port_core.ORIGINAL).as_posix()
                        for p in port_core.ORIGINAL.rglob("*.py"))


# ---------------------------------------------------------------------------
# (a) the copy stays a copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", ORIGINAL_FILES)
def test_core_file_is_the_original_with_the_prefix_rewritten(rel):
    """Each file equals its original after ``repro.core`` -> ``repro_torch.
    core`` (change-history tags dropped), but for the named torch seams,
    which are the port's own."""
    original = (port_core.ORIGINAL / rel).read_text()
    port = (port_core.PORT / rel).read_text()
    names = port_core.DIVERGENT.get(rel, ())
    assert port == port_core.render(original, port, names)
    assert "repro.core" not in port.replace("repro_torch.core", "")
    assert "(PR " not in port


def test_the_copy_has_every_file_and_no_other():
    ours = sorted(p.relative_to(port_core.PORT).as_posix()
                  for p in port_core.PORT.rglob("*.py"))
    assert ours == ORIGINAL_FILES and len(ours) == 46


def test_only_the_named_seams_diverge():
    assert port_core.DIVERGENT == {
        "engines/local.py": ("_hash_value", "cache_key", "LocalEngine._ckpt_session",
                             "LocalEngine._profiled_invoke", "_block_until_ready",
                             "_device_memory_bytes"),
        "autotune.py": ("train_real_model",),
        "analysis/ndet.py": ("_is_rng_module_call", "_scan")}
    for rel, names in port_core.DIVERGENT.items():
        original = port_core.rewrite((port_core.ORIGINAL / rel).read_text())
        port = (port_core.PORT / rel).read_text()
        theirs, ours = port_core.spans(original, names), port_core.spans(port, names)
        for name in names:       # each seam really is the port's own
            a, b = theirs[name]
            c, d = ours[name]
            assert original.splitlines()[a:b + 1] != port.splitlines()[c:d + 1], name


def test_render_takes_only_the_named_functions_from_the_port():
    original = ("from repro.core.ir import Job\n\n\ndef f():\n    return 1\n\n\n"
                "class C:\n    def g(self):\n        return 2\n")
    port = original.replace("repro.core", "repro_torch.core").replace(
        "return 2", "return 3").replace("return 1", "return 4")
    out = port_core.render(original, port, ("C.g",))
    assert "return 3" in out and "return 1" in out and "return 4" not in out
    assert out.startswith("from repro_torch.core.ir import Job")
    with pytest.raises(KeyError):
        port_core.render(original, port, ("h",))


# ---------------------------------------------------------------------------
# (b) torch artifacts are keyed by content
# ---------------------------------------------------------------------------

def _equal_variants():
    """Tensors equal to arange(12).reshape(3, 4) in other storage."""
    a = torch.arange(12.).reshape(3, 4)
    in_larger = torch.zeros(2, 3, 4)[1]         # a view at an offset
    in_larger.copy_(a)
    strided = a.t().contiguous().t()            # not contiguous
    grad = a.clone().requires_grad_(True)
    param = torch.nn.Parameter(a.clone())
    return a, [a.clone(), in_larger, strided, grad, param]


def test_equal_tensors_hash_equal_whatever_their_storage():
    a, variants = _equal_variants()
    for v in variants:
        assert L._hash_value(v) == L._hash_value(a)


@pytest.mark.parametrize("wrap", [
    lambda t: {"w": t, "meta": 3}, lambda t: [t, "x"], lambda t: (1, (t,)),
    lambda t: {"nested": [{"t": t}]}], ids=["dict", "list", "tuple", "nested"])
def test_containers_of_equal_tensors_hash_equal(wrap):
    a, variants = _equal_variants()
    for v in variants:
        assert L._hash_value(wrap(v)) == L._hash_value(wrap(a))


@pytest.mark.parametrize("change", [
    lambda t: t.double(), lambda t: t.reshape(4, 3), lambda t: t.reshape(12),
    lambda t: t.index_put((torch.tensor([1]), torch.tensor([2])), torch.tensor(0.5)),
    lambda t: t.bfloat16()], ids=["dtype", "shape", "flat", "one-element", "bf16"])
def test_a_change_of_dtype_shape_or_one_element_changes_the_key(change):
    a = torch.arange(12.).reshape(3, 4)
    assert L._hash_value(change(a)) != L._hash_value(a)


def test_bf16_tensors_hash_by_content():
    a = torch.linspace(-3, 3, 50).bfloat16()
    b = torch.zeros(100, dtype=torch.bfloat16)[::2]
    b.copy_(a)
    assert L._hash_value(a) == L._hash_value(b) == L._hash_value(a.clone())
    c = a.clone()
    c[7] = c[7] + 1
    assert L._hash_value(c) != L._hash_value(a)
    assert L._hash_value(torch.tensor(1.5, dtype=torch.bfloat16)) != \
        L._hash_value(torch.tensor(1.5, dtype=torch.float16))


def test_modules_with_equal_parameters_hash_equal():
    torch.manual_seed(0)
    m = torch.nn.ModuleDict({"l": torch.nn.Linear(4, 4)})
    n = torch.nn.ModuleDict({"l": torch.nn.Linear(4, 4)})
    assert L._hash_value(m) != L._hash_value(n)
    n.load_state_dict(m.state_dict())
    assert L._hash_value(m) == L._hash_value(n)


@pytest.mark.parametrize("value", [
    1, 2.5, "text", None, (1, "a"), {"a": [1, 2, (3, None)]},
    np.arange(6, dtype=np.int32).reshape(2, 3), {"big": np.arange(300_000.0)}],
    ids=["int", "float", "str", "none", "tuple", "dict", "ndarray", "large-ndarray"])
def test_values_without_tensors_hash_as_in_the_reference(value):
    assert L._hash_value(value) == JL._hash_value(value)


def test_the_reference_key_hashes_a_tensor_by_identity():
    """Why the seam exists: the pickle key of the JAX package gives two equal
    live tensors two keys (a tensor's pickle names its storage's address)."""
    a, b = torch.arange(10.), torch.arange(10.)
    assert JL._hash_value(a) != JL._hash_value(b)
    assert L._hash_value(a) == L._hash_value(b)


# ---------------------------------------------------------------------------
# (b2) the reference's three wrong-hit keys, repaired in the port
# ---------------------------------------------------------------------------

def _job(fn, *args, **kwargs):
    """The IR job of one step running ``fn``."""
    with couler.workflow("keys") as ir:
        couler.run_step(fn, *args, step_name="step", **kwargs)
    return ir.jobs["step"]


def test_a_value_that_does_not_pickle_keys_its_tensors_by_content():
    """The reference's fallback keys such a value by its ``repr``, which
    summarises a tensor of more than 1,000 elements: one element apart, the
    two values got one key. Tensor-free, the fallback stays the reference's."""
    f = lambda x: x                                   # noqa: E731
    w = torch.zeros(4096)
    w2 = w.clone()
    w2[2048] = 1
    a, b = {"w": w, "f": f}, {"w": w2, "f": f}
    assert repr(a) == repr(b)
    assert L._hash_value(a) != L._hash_value(b)
    assert L._hash_value(a) == L._hash_value({"w": w.clone(), "f": f})
    plain = {"n": np.zeros(3), "f": f}
    assert L._hash_value(plain) == JL._hash_value(plain)


def test_a_tensor_in_a_part_that_does_not_pickle_gets_no_reusable_key():
    """A part that neither pickles nor reduces (here a generator whose frame
    holds a tensor) cannot be walked, and a tensor may hide in it."""
    def gen(t):
        yield t
    v = {"g": gen(torch.zeros(3)), "t": torch.ones(2)}
    assert L._hash_value(v) is None
    assert L._hash_value({"g": gen(torch.zeros(3))}) is None
    job = _job(lambda t: t, v)
    assert L.cache_key(job, {}) != L.cache_key(job, {})


def test_a_part_that_does_not_pickle_is_walked_through_its_reduction():
    """A partial with a lambda among its keywords does not pickle; its
    function, arguments and keywords are walked, its tensor keyed by content."""
    import functools
    f = lambda x: x                                   # noqa: E731
    a = {"p": functools.partial(torch.add, torch.zeros(3), alpha=f), "t": torch.ones(2)}
    b = {"p": functools.partial(torch.add, torch.tensor([0., 1., 0.]), alpha=f),
         "t": torch.ones(2)}
    assert L._hash_value(a) is not None
    assert L._hash_value(a) != L._hash_value(b)
    assert L._hash_value(a) == L._hash_value(
        {"p": functools.partial(torch.add, torch.zeros(3), alpha=f), "t": torch.ones(2)})


class _Holder:
    """A lock before a weight, and a repr that names neither: its pickle
    fails at the lock, before it meets the tensor."""

    def __init__(self, w):
        self.lock = threading.Lock()
        self.w = w

    def __repr__(self):
        return "_Holder()"


def test_an_object_holding_a_lock_before_a_tensor_is_keyed_by_the_tensor():
    """The reference falls back to the constant repr: two holders one
    element apart got one key, as step arguments and as artifacts."""
    w = torch.zeros(4096)
    w2 = w.clone()
    w2[2048] = 1
    a, b = _Holder(w), _Holder(w2)
    assert repr(a) == repr(b) and JL._hash_value(a) == JL._hash_value(b)
    assert L._hash_value(a) != L._hash_value(b)
    assert L._hash_value(a) == L._hash_value(a)
    assert None not in (L._hash_value(a), L._hash_value(b))

    def use(h):
        return float(h.w.sum())
    assert L.cache_key(_job(use, a), {}) != L.cache_key(_job(use, b), {})
    assert L.cache_key(_job(use, a), {}) == L.cache_key(_job(use, a), {})
    # the same holder with the tensor changed in place gets another key
    before = L._hash_value(a)
    w[0] = 5
    assert L._hash_value(a) != before


def test_two_holders_of_equal_tensors_share_a_key():
    """The lock in a holder is keyed by its type, not by its repr (which
    holds its address and whether it is held), so separate holders of equal
    tensors share a key, as a resubmission in a new process would."""
    a, b = _Holder(torch.arange(4096.0)), _Holder(torch.arange(4096.0))
    b.lock.acquire()
    assert repr(a.lock) != repr(b.lock)
    assert L._hash_value(a) == L._hash_value(b) is not None

    def use(h):
        return float(h.w.sum())
    assert L.cache_key(_job(use, a), {}) == L.cache_key(_job(use, b), {})
    b.lock.release()


def test_a_tensor_free_object_that_does_not_pickle_keeps_the_reference_key():
    class Plain:
        def __init__(self):
            self.lock = threading.Lock()
            self.n = 3

        def __repr__(self):
            return "Plain()"
    for v in (Plain(), {"p": Plain(), "k": [1, 2]}, threading.Lock()):
        assert L._hash_value(v) == JL._hash_value(v)


def test_a_literal_tensor_argument_is_keyed_by_content():
    """The reference keys a literal argument by ``repr``: a tensor of 4096
    zeros and the same with one element set got one key."""
    def use(t, scale=None):
        return float(t.sum())

    w = torch.zeros(4096)
    w2 = w.clone()
    w2[2048] = 1
    assert repr(w) == repr(w2)
    assert L.cache_key(_job(use, w), {}) != L.cache_key(_job(use, w2), {})
    assert L.cache_key(_job(use, w), {}) == L.cache_key(_job(use, w.clone()), {})
    assert L.cache_key(_job(use, 1, scale=w), {}) != L.cache_key(_job(use, 1, scale=w2), {})
    # a tensor-free literal keeps the reference's repr
    assert L.cache_key(_job(use, (1, "a")), {}) != L.cache_key(_job(use, (1, "b")), {})


def _make_train(lr):
    def train(steps):
        return lr * steps
    return train


def _f():
    return 0.1


def _g():
    return 0.2


def test_a_function_is_keyed_by_its_constants_closure_and_defaults():
    """The reference keys a step's function by ``co_code`` alone: closures
    built at two learning rates, and two functions that differ in a
    constant, each got one key. Closures built afresh with equal contents
    still get one key."""
    def key(fn, *args):
        return L.cache_key(_job(fn, *args), {})

    assert key(_make_train(3e-4), 5) != key(_make_train(3e-3), 5)
    assert key(_make_train(3e-4), 5) == key(_make_train(3e-4), 5)
    assert key(_f) != key(_g)

    def with_default(x, lr=3e-4):
        return x * lr

    def with_other_default(x, lr=3e-3):
        return x * lr

    def with_kwdefault(x, *, lr=3e-4):
        return x * lr

    def with_other_kwdefault(x, *, lr=3e-3):
        return x * lr

    assert key(with_default, 1) != key(with_other_default, 1)
    assert key(with_kwdefault, 1) != key(with_other_kwdefault, 1)

    def nested(lr):                 # a closure over a closure, and a cycle
        inner = _make_train(lr)

        def step(n):
            return inner(n) + (step is not None)
        return step

    assert key(nested(3e-4), 2) == key(nested(3e-4), 2)
    assert key(nested(3e-4), 2) != key(nested(3e-3), 2)
    lam = [lambda: 1, lambda: 2]
    assert key(lam[0]) != key(lam[1])


class _Trainer:
    def __init__(self, lr):
        self.lr = lr

    def step(self, n):
        return self.lr * n


def test_a_bound_method_is_keyed_by_its_self():
    """The reference keys a bound method by its function: two trainers at
    two learning rates, submitted as one step, got one key and the second
    took the first's result."""
    def key(fn, *args):
        return L.cache_key(_job(fn, *args), {})

    assert key(_Trainer(3e-4).step, 5) != key(_Trainer(3e-3).step, 5)
    assert key(_Trainer(3e-4).step, 5) == key(_Trainer(3e-4).step, 5)


LR = 3e-4


def _global_step(n):
    return LR * n


def test_a_changed_global_changes_the_key():
    """The reference keys the code but not the module globals it reads: a
    global learning rate changed between two submissions still hit.
    Functions and modules stay keyed by name."""
    global LR
    k0 = L.cache_key(_job(_global_step, 5), {})
    try:
        LR = 3e-3
        k1 = L.cache_key(_job(_global_step, 5), {})
        LR = 3e-4
        assert L.cache_key(_job(_global_step, 5), {}) == k0
    finally:
        LR = 3e-4
    assert k0 != k1


def test_a_sweep_of_closures_under_one_step_name_gets_each_trials_result():
    """§IV.C's shape: trials built as closures under one step name, in one
    engine. Each gets its own result, and a repeated trial hits."""
    def build(lr):
        with couler.workflow("sweep") as ir:
            couler.run_step(_make_train(lr), 10, step_name="trial")
        return ir

    eng = L.LocalEngine(cache=CacheStore(), enable_speculation=False)
    try:
        runs = [eng.submit(build(lr)) for lr in (3e-4, 3e-3, 3e-4)]
    finally:
        eng.close()
    assert [r.artifacts["trial:out"] for r in runs] == [3e-4 * 10, 3e-3 * 10, 3e-4 * 10]
    assert [r.steps["trial"].status for r in runs] == [
        StepStatus.SUCCEEDED, StepStatus.SUCCEEDED, StepStatus.CACHED]


def test_recomputed_equal_tensor_keeps_its_consumer_cached():
    """A non-cacheable step returns an equal tensor artifact in a new tensor
    on every submission; its cacheable consumer is Cached the second time.
    With the reference's pickle key it would run again. The call counts sit
    on the functions: a closure's contents are part of its key."""
    def make():
        make.calls += 1
        return {"w": torch.arange(64.).reshape(8, 8) * 0.5,
                "b": [torch.ones(3, dtype=torch.bfloat16)]}

    def use(t):
        use.calls += 1
        return float(t["w"].sum()) + float(t["b"][0].sum())

    make.calls = use.calls = 0

    def build():
        with couler.workflow("recompute") as ir:
            t = couler.run_step(make, step_name="make", cacheable=False)
            couler.run_step(use, t, step_name="use")
        return ir

    eng = L.LocalEngine(cache=CacheStore(), enable_speculation=False)
    try:
        r1, r2 = eng.submit(build()), eng.submit(build())
    finally:
        eng.close()
    assert r1.succeeded() and r2.succeeded()
    assert r2.steps["make"].status == StepStatus.SUCCEEDED
    assert r2.steps["use"].status == StepStatus.CACHED
    assert (make.calls, use.calls) == (2, 1)
    assert r2.artifacts["use:out"] == r1.artifacts["use:out"] == 1011.0
    assert r1.artifacts["make:out"]["w"] is not r2.artifacts["make:out"]["w"]


# ---------------------------------------------------------------------------
# (c) twin of tests/test_system.py::test_ml_workflow_with_real_training_and_cache_reuse
# ---------------------------------------------------------------------------

def _system_cfgs():
    spec, jspec = get_arch("stablelm-1.6b"), jget_arch("stablelm-1.6b")
    kw = dict(param_dtype="float32", compute_dtype="float32")
    cfg, jcfg = reduced(spec.model).replace(**kw), jreduced(jspec.model).replace(**kw)
    tkw = dict(optimizer="adamw", learning_rate=1e-3, remat="none")
    return cfg, spec.train.__class__(**tkw), jcfg, jspec.train.__class__(**tkw)


def _tokenize_fn(vocab):
    """The call count sits on the function: the port keys a closure's
    contents, so a count in a closure cell would change the step's key."""
    def tokenize():
        tokenize.calls += 1
        rng = np.random.default_rng(0)
        return rng.integers(0, vocab, (8, 33)).astype(np.int32)
    tokenize.calls = 0
    return tokenize


def _evaluate(losses):
    return losses[-1] < losses[0]


def _run_twice(cpl, engine, tokenize, train):
    def build():
        with cpl.workflow("train-pipeline") as ir:
            d = cpl.run_step(tokenize, step_name="tokenize")
            t = cpl.run_step(train, d, step_name="train")
            cpl.run_step(_evaluate, t, step_name="eval")
        return ir
    try:
        return engine.submit(build()), engine.submit(build())
    finally:
        engine.close()


def test_ml_workflow_with_real_training_matches_the_jax_workflow():
    """The same workflow on both engines, each with its own payload, the
    port's started from JAX's init: equal step statuses, tokenize Cached on
    the second submission, and the losses of JAX at STEP_RTOL."""
    cfg, tcfg, jcfg, jtcfg = _system_cfgs()
    init = jax.tree.map(np.asarray, JTR.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0)))

    def jtrain(data, steps=3):
        state = JTR.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
        step = jax.jit(JTR.make_train_step(jcfg, jtcfg))
        losses = []
        for _ in range(steps):
            batch = {"tokens": jnp.asarray(data[:, :-1]),
                     "targets": jnp.asarray(data[:, 1:])}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return losses

    def train(data, steps=3):
        state = bridge.state_from_jax(init, cfg, "cpu")
        step = TR.make_train_step(cfg, tcfg)
        losses = []
        for _ in range(steps):
            batch = TR.to_device({"tokens": data[:, :-1], "targets": data[:, 1:]}, "cpu")
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return losses

    jtokenize, tokenize = _tokenize_fn(jcfg.vocab_size), _tokenize_fn(cfg.vocab_size)
    jruns = _run_twice(jcouler, JL.LocalEngine(
        cache=JCacheStore(capacity_bytes=1 << 24, policy=JCoulerPolicy()),
        enable_speculation=False), jtokenize, jtrain)
    runs = _run_twice(couler, L.LocalEngine(
        cache=CacheStore(capacity_bytes=1 << 24, policy=CoulerPolicy()),
        enable_speculation=False), tokenize, train)
    for jr, r in zip(jruns, runs):
        assert r.succeeded() and jr.succeeded()
        assert {k: s.status.value for k, s in r.steps.items()} == \
            {k: s.status.value for k, s in jr.steps.items()}
    assert runs[0].artifacts["eval:out"] is True
    assert runs[1].steps["tokenize"].status == StepStatus.CACHED
    assert jruns[1].steps["tokenize"].status == JStepStatus.CACHED
    assert tokenize.calls == jtokenize.calls == 1
    np.testing.assert_allclose(runs[0].artifacts["train:out"],
                               jruns[0].artifacts["train:out"], rtol=STEP_RTOL)


# ---------------------------------------------------------------------------
# (d) twin of tests/test_faults.py::test_checkpoint_wired_step_resumes_mid_step
# ---------------------------------------------------------------------------

def _ckpt_train_fn(cfg, tcfg, batches, losses, work_log, starts):
    """A checkpoint-wired train step of the reduced model: one iteration a
    batch, the train state saved after each; ``losses[i]`` is iteration i's
    loss, the last attempt's where an iteration ran twice; ``starts`` the
    first iteration of each attempt."""
    def train(n, ckpt=None):
        state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
        start = 0
        if ckpt.latest_step() is not None:
            state = ckpt.restore(like=state)
            start = ckpt.latest_step() + 1
        starts.append(start)
        step = TR.make_train_step(cfg, tcfg)
        for i in range(start, n):
            ckpt.tick(i)                      # interruption point
            work_log.append(i)
            state, m = step(state, TR.to_device(batches[i], "cpu"))
            losses[i] = float(m["loss"])
            ckpt.save(i, state)
        return int(state["step"])
    return train


def test_checkpoint_wired_train_step_resumes_mid_step():
    iters = 6
    cfg = reduced(get_arch("stablelm-1.6b").model).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch("stablelm-1.6b").train,
                               learning_rate=1e-3, remat="none")
    batches = list(pipeline.synthetic_batches(2, 16, cfg.vocab_size, seed=3, n=iters))
    out = {}
    for name, plan in (("uninterrupted", None),
                       ("killed", FaultPlan(seed=5, worker_loss_rate=1.0,
                                            max_failures_per_site=2,
                                            mid_step_kill_window=4,
                                            targets=frozenset(["ck/train"])))):
        losses, work_log, starts = {}, [], []
        with tempfile.TemporaryDirectory() as td:
            with couler.workflow("ck") as ir:
                couler.add_job(_ckpt_train_fn(cfg, tcfg, batches, losses, work_log, starts),
                               iters, checkpoint=td + "/ck", step_name="train",
                               retry_limit=8)
            eng = L.LocalEngine(cache=CacheStore(), enable_speculation=False,
                                check_events=True, retry_backoff_s=0.001,
                                retry_backoff_max_s=0.01, fault_plan=plan)
            try:
                run = eng.submit(ir)
            finally:
                eng.close()
            saved = sorted(p.name for p in Path(td, "ck").glob("step_*"))
        assert run.succeeded()
        assert run.artifacts["train:out"] == iters
        assert saved == [f"step_{i:08d}" for i in range(iters - 3, iters)]
        out[name] = (losses, work_log, starts, run, eng)
    losses, work_log, starts, run, eng = out["killed"]
    assert eng.injector.stats["mid_step_kill"] == 2
    assert run.steps["train"].attempts == 3
    # progress survived the kills through the port's checkpoints
    assert len(work_log) < run.steps["train"].attempts * iters
    assert len(starts) == 3 and starts[0] == 0 and starts[-1] > 0
    want = out["uninterrupted"][0]
    assert sorted(losses) == sorted(want) == list(range(iters))
    np.testing.assert_allclose([losses[i] for i in range(iters)],
                               [want[i] for i in range(iters)], rtol=STEP_RTOL)


# ---------------------------------------------------------------------------
# (e) train_real_model, the Fig. 8 payload
# ---------------------------------------------------------------------------

def _jax_init(cfg, tcfg):
    """``train_real_model``'s ``init_state``: JAX's init of seed 0, bridged."""
    jspec = jget_arch("stablelm-1.6b")
    jcfg = jreduced(jspec.model).replace(
        d_model=cfg.d_model, vocab_size=cfg.vocab_size, pad_vocab_multiple=16,
        param_dtype="float32", compute_dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jtcfg = jspec.train.__class__(**dataclasses.asdict(tcfg))
    jstate = JTR.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    return bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")


def test_train_real_model_matches_jax():
    hp = {"learning_rate": 3e-3, "batch_size": 16}
    theirs = JA.train_real_model(hp, steps=30)
    ours = A.train_real_model(hp, steps=30, device="cpu", init_state=_jax_init)
    assert ours.keys() == theirs.keys() and ours["hparams"] == theirs["hparams"]
    assert len(ours["losses"]) == 30
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=STEP_RTOL)
    np.testing.assert_allclose(ours["final_loss"], theirs["final_loss"], rtol=STEP_RTOL)


def test_train_real_model_good_lr_beats_bad():
    good = A.train_real_model({"learning_rate": 3e-3, "batch_size": 16},
                              steps=30, device="cpu")
    bad = A.train_real_model({"learning_rate": 3.0, "batch_size": 16},
                             steps=30, device="cpu")
    assert good["losses"][0] > good["final_loss"]
    assert good["final_loss"] < bad["final_loss"]


def test_train_real_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        A.train_real_model({}, steps=1)


# ---------------------------------------------------------------------------
# (f) the data pipeline
# ---------------------------------------------------------------------------

def test_sharded_corpus_and_reader_are_copies():
    import inspect
    for name in ("ShardedCorpus", "CachedShardReader"):
        assert inspect.getsource(getattr(pipeline, name)) == \
            inspect.getsource(getattr(jpipe, name))
    assert pipeline.CacheStore is CacheStore


def test_sharded_corpus_writes_the_jax_shards(tmp_path):
    ours = pipeline.ShardedCorpus(str(tmp_path / "a" / "shards"), n_shards=3,
                                  tokens_per_shard=500, vocab=97, seed=2)
    theirs = jpipe.ShardedCorpus(str(tmp_path / "b" / "shards"), n_shards=3,
                                 tokens_per_shard=500, vocab=97, seed=2)
    for p, q in zip(ours.materialize(), theirs.materialize()):
        assert p.read_bytes() == q.read_bytes()
    np.testing.assert_array_equal(ours.read_shard(1), theirs.read_shard(1))


def test_cached_shard_reader_yields_the_jax_batches_and_hits_on_a_second_epoch(tmp_path):
    kw = dict(n_shards=4, tokens_per_shard=300, vocab=64, seed=1)
    ours = pipeline.CachedShardReader(pipeline.ShardedCorpus(str(tmp_path / "a"), **kw))
    theirs = jpipe.CachedShardReader(jpipe.ShardedCorpus(str(tmp_path / "b"), **kw))
    ours.corpus.materialize()
    theirs.corpus.materialize()
    first = list(ours.batches(2, 20, epochs=1))
    assert ours.cache.hit_ratio() == 0.0
    second = list(ours.batches(2, 20, epochs=1))
    assert ours.cache.hit_ratio() == 0.5          # every shard of epoch 2 hit
    want = list(theirs.batches(2, 20, epochs=2))
    assert len(first) + len(second) == len(want) > 0
    for a, b in zip(first + second, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert theirs.cache.hit_ratio() == ours.cache.hit_ratio()


# ---------------------------------------------------------------------------
# (g) profiling
# ---------------------------------------------------------------------------

def test_profiled_step_on_the_cpu_records_execute_s_only():
    def work(n):
        x = torch.ones(n, n)
        return x @ x

    with couler.workflow("prof") as ir:
        couler.run_step(work, 64, step_name="work")
    eng = L.LocalEngine(profile_steps=True, enable_speculation=False)
    try:
        run = eng.submit(ir)
        snap = eng.gateway.registry.snapshot()
    finally:
        eng.close()
    assert run.succeeded()
    prof = run.steps["work"].profile
    assert set(prof) == {"execute_s"} and prof["execute_s"] >= 0
    assert snap["step_execute_s"]["count"] == 1
    assert "step_compile_s" not in snap


def test_the_fence_and_the_memory_reading_wait_for_cuda():
    """Without CUDA initialised neither touches a device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    L._block_until_ready(torch.ones(2))
    assert L._device_memory_bytes() is None


# ---------------------------------------------------------------------------
# (h) CLR007: the nondeterminism pass sees torch's global generator
# ---------------------------------------------------------------------------

# the JAX linter's own cases (tests/test_analysis.py), and more of its kinds
def _noisy_fn():
    return random.random()


def _seeded_fn():
    rng = random.Random(0)
    return rng.normalvariate(0, 1)


def _clocky_fn():
    return time.time()


def _np_draw_fn():
    return np.random.rand(3)


def _np_unseeded_rng_fn():
    return np.random.default_rng().normal()


def _np_seeded_rng_fn():
    return np.random.default_rng(0).normal()


def _jax_key_fn():
    return jax.random.normal(jax.random.PRNGKey(0), (3,))


def _seeded_then_clock_fn():
    random.seed(1)
    return random.random(), time.perf_counter()


# draws from torch's global generator, through the torch module
def _torch_randn_fn(x):
    return x + torch.randn(4)


def _torch_draws_fn():
    return torch.rand(3), torch.randint(0, 4, (2,)), torch.randperm(5)


def _torch_init_fn(w):
    torch.nn.init.normal_(w)
    return w.uniform_()


def _torch_more_draws_fn(p):
    return (torch.normal(0.0, 1.0, (3,)), torch.bernoulli(p), torch.multinomial(p, 1),
            torch.poisson(p), torch.randn_like(p), torch.empty(3).normal_())


def _torch_seeded_fn(x):
    torch.manual_seed(0)
    return x + torch.randn(4)


def _torch_generator_fn(x):
    g = torch.Generator().manual_seed(0)
    return x + torch.randn(4, generator=g), torch.empty(3).uniform_(generator=g)


def _torch_explicit_generator_fn(x, g):
    return x + torch.randint(0, 9, (4,), generator=g)


def _torch_fill_fn(w):
    torch.nn.init.zeros_(w)
    torch.nn.init.ones_(w)
    return torch.nn.init.constant_(w, 2.0)


JAX_LINTER_CASES = [_noisy_fn, _seeded_fn, _clocky_fn, len, _np_draw_fn,
                    _np_unseeded_rng_fn, _np_seeded_rng_fn, _jax_key_fn,
                    _seeded_then_clock_fn]


@pytest.mark.parametrize("fn", JAX_LINTER_CASES, ids=lambda f: f.__name__)
def test_clr007_gives_the_jax_linters_findings(fn):
    """Every kind of call the JAX package's pass judges is judged the same."""
    assert findings(fn) == jfindings(fn)
    assert bool(findings(fn)) == (fn in (_noisy_fn, _clocky_fn, _np_draw_fn,
                                         _np_unseeded_rng_fn, _seeded_then_clock_fn))


@pytest.mark.parametrize("fn,want", [
    (_torch_randn_fn, ("torch.randn()",)),
    (_torch_draws_fn, ("torch.rand()", "torch.randint()", "torch.randperm()")),
    (_torch_init_fn, ("torch.nn.init.normal_()", "w.uniform_()")),
    (_torch_more_draws_fn, ("torch.normal()", "torch.bernoulli()", "torch.multinomial()",
                            "torch.poisson()", "torch.randn_like()", "(...).normal_()"))],
    ids=lambda v: getattr(v, "__name__", ""))
def test_clr007_flags_torchs_global_generator(fn, want):
    assert sorted(findings(fn)) == sorted(want)
    assert jfindings(fn) == ()           # the JAX pass knows no torch


@pytest.mark.parametrize("fn", [_torch_seeded_fn, _torch_generator_fn,
                                _torch_explicit_generator_fn, _torch_fill_fn],
                         ids=lambda f: f.__name__)
def test_clr007_excuses_seeded_and_generator_draws(fn):
    assert findings(fn) == ()


def _torch_draw_step():
    return torch.randn(2)


def _one_step_workflow(ir_cls, job_cls, fn, cacheable=True):
    """The JAX linter tests' chain of two steps, the second running ``fn``."""
    wf = ir_cls("ndet")
    wf.add_job(job_cls(name="a", fn=_seeded_fn, outputs=["a:out"]))
    wf.add_job(job_cls(name="b", fn=fn, outputs=["b:out"], cacheable=cacheable))
    wf.add_edge("a", "b")
    return wf


@pytest.mark.parametrize("fn", [_noisy_fn, _seeded_fn, _clocky_fn],
                         ids=lambda f: f.__name__)
def test_clr007_lints_a_workflow_as_the_jax_linter(fn):
    """The JAX linter's mutation case: the same warnings in both packages,
    never an error, and none for a step that is not cacheable."""
    from repro.core.ir import Job as JJob, WorkflowIR as JWorkflowIR
    for cacheable in (True, False):
        res = lint(_one_step_workflow(WorkflowIR, Job, fn, cacheable))
        jres = jlint(_one_step_workflow(JWorkflowIR, JJob, fn, cacheable))
        assert res.codes() == jres.codes() and res.ok()
        assert [d.message for d in res.warnings] == [d.message for d in jres.warnings]


def test_a_cacheable_torch_draw_step_is_warned_at_submit():
    """On the port's engine the warning is recorded, the step runs."""
    wf = _one_step_workflow(WorkflowIR, Job, _torch_draw_step)
    eng = L.LocalEngine(max_workers=2, enable_speculation=False, promote_interval_s=0.0)
    try:
        run = eng.submit(wf)
    finally:
        eng.close()
    assert run.status == "Succeeded"
    assert any(d["code"] == "CLR007" and "torch.randn" in d["message"]
               for d in wf.configs["lint_warnings"])


# ---------------------------------------------------------------------------
# the drivers, on the CPU
# ---------------------------------------------------------------------------

def test_train_lm_driver_runs_the_workflow_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm
    run = train_lm.main(["--device", "cpu", "--steps", "50", "--d-model", "64",
                         "--seq", "32", "--batch", "4", "--out", str(tmp_path)])
    assert run.succeeded() and run.artifacts["evaluate:out"] is True
    assert {k: s.status for k, s in run.steps.items()} == {
        "prepare-corpus": StepStatus.SUCCEEDED, "train": StepStatus.SUCCEEDED,
        "evaluate": StepStatus.SUCCEEDED}
    assert (tmp_path / "ckpt" / "step_00000050" / "manifest.json").exists()
    assert "step   50 loss" in capsys.readouterr().out


def test_serve_lm_driver_decodes_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    gen = serve_lm.main(["--device", "cpu", "--arch", "stablelm-1.6b",
                         "--prompt-len", "6", "--gen-len", "5"])
    assert gen.shape == (4, 5)
    assert "decode:  5 toks x 4 reqs" in capsys.readouterr().out


def test_automl_driver_selects_on_the_cpu(monkeypatch):
    from repro_torch.examples import automl_pipeline
    calls, real = [], A.train_real_model

    def short(hparams, **kw):                # the real payload, fewer steps
        calls.append(kw["device"])
        return real(hparams, steps=8, **kw)
    monkeypatch.setattr(A, "train_real_model", short)
    run = automl_pipeline.main(["--device", "cpu"])
    assert run.succeeded() and calls == ["cpu", "cpu"]
    sel = run.artifacts["select:out"]
    assert sel["winner"] in ("ours", "baseline")
    assert sel["winner"] == ("ours" if sel["ours"] < sel["baseline"] else "baseline")


def test_drivers_default_to_the_card():
    from repro_torch.examples import automl_pipeline, serve_lm, train_lm
    for mod in (train_lm, serve_lm, automl_pipeline):
        assert mod.parser().parse_args([]).device == "cuda"
    # the JAX drivers' defaults
    assert vars(train_lm.parser().parse_args([])) == dict(
        arch="stablelm-1.6b", steps=200, d_model=128, seq=64, batch=8,
        out="out/train_lm", device="cuda")
    assert vars(serve_lm.parser().parse_args([])) == dict(
        arch="mamba2-370m", batch=4, prompt_len=12, gen_len=24, device="cuda")
