"""Adafactor held to the JAX package's at deepseek-v3-671b's full-width leaf
shapes, on the CPU.

The other Adafactor parity tests run reduced widths. Here JAX's
``adafactor_update`` and the port's take identical seeded params and
gradients for 3 updates at the configuration's lr 3e-4 and weight decay
0.1, the state carried
between them, on leaves of the 2-layer cut that ``chip_smoke.py`` trains:

- ``dense_layers/mlp/gate``, the two dense layers' SwiGLU weight stacked,
  (2, 7168, 18432): 264 M elements under one RMS clip, factored over its
  last two axes. It stands for the embedding (129280, 7168) and the two
  heads (7168, 129280), which take the same path (a leaf factored over its
  last two axes, one clip over the whole leaf) but hold 3.7 GB each in fp32,
  too much for a test beside five other workers;
- ``dense_layers/ln1/scale`` (2, 7168): a stacked norm scale, which JAX
  factors over the layer axis;
- MLA's ``wq_a`` (2, 7168, 1536), ``wkv_a`` (2, 7168, 576) and the query
  up-projection ``wq_b`` (2, 1536, 128 x 192);
- ``final_norm/scale`` (7168,): unfactored, its second moment in ``v``.

The port keeps one tensor a layer and stacks them for the update, keying
``vr``/``vc``/``v`` by JAX path. New params, ``vr``, ``vc`` and ``v`` must
agree within 2e-5 of each leaf's largest magnitude. Each leaf runs alone,
JAX then the port (JAX's new params kept on disk meanwhile), so a leaf's
peak holds its params and gradient and the update's buffers: at the MLP
leaf (1.06 GB in fp32) the params and gradient, 2.1 GB, and the port's
out-of-place update, which holds up to four buffers of the leaf's size (the
stacked gradient and the update's temporaries), 6.7 GB in all.

Each leaf runs in a process of its own, which writes what the test reads
(shapes and errors) to a JSON file and exits: a test process's allocator
keeps the pages it once held, so the test's worker would otherwise keep
its 6.7 GB for the rest of the suite. The file is that process's program:
``python tests/test_torch_fullwidth.py PATH OUT_DIR``.
"""
import functools
import json
import os
import subprocess
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
# one leaf's process alone takes 10-25 s on 8 cores
LEAF_TIMEOUT_S = 600

# the configuration's Adafactor: lr 3e-4, weight decay 0.1
LR, WD, STEPS, TOL = 3e-4, 0.1, 3, 2e-5
# JAX path -> (port name pattern, the stacked leaf's shape)
LEAVES = {
    "dense_layers/mlp/gate": ("dense_layers.{}.mlp.gate", (2, 7168, 18432)),
    "dense_layers/ln1/scale": ("dense_layers.{}.ln1.scale", (2, 7168)),
    "dense_layers/attn/wq_a": ("dense_layers.{}.attn.wq_a", (2, 7168, 1536)),
    "dense_layers/attn/wkv_a": ("dense_layers.{}.attn.wkv_a", (2, 7168, 576)),
    "dense_layers/attn/wq_b": ("dense_layers.{}.attn.wq_b", (2, 1536, 128 * 192)),
    "final_norm/scale": ("final_norm.scale", (7168,)),
}


def _uniform(rng, shape, scale):
    """Seeded fp32 uniform on [-scale, scale) (a third of a normal draw's
    time at these sizes)."""
    x = rng.random(shape, dtype=np.float32)
    x -= np.float32(0.5)
    x *= np.float32(2 * scale)
    return x


def _param(path, shape):
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    x = _uniform(rng, shape, 0.1 if path.endswith("scale") else 0.03)
    if path.endswith("scale"):
        x += np.float32(1.0)
    return x


def _grad(path, shape, step):
    """A seeded gradient whose rows and columns differ in scale, so that the
    factored moments are not flat."""
    rng = np.random.default_rng((zlib.crc32(path.encode()), step))
    g = _uniform(rng, shape, 1e-3)
    if len(shape) >= 2:
        g *= np.exp(rng.standard_normal(shape[:-1] + (1,), dtype=np.float32))
        g *= np.exp(rng.standard_normal(shape[:-2] + (1, shape[-1]), dtype=np.float32))
    return g


def _jax(path, shape, out):
    """3 JAX updates; the new params saved to ``out`` (read back mapped),
    the moments returned."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as JO
    step = jax.jit(functools.partial(JO.adafactor_update, lr=LR, weight_decay=WD),
                   donate_argnums=(0, 1, 2))
    params = {path: jnp.asarray(_param(path, shape))}
    state = JO.adafactor_init(params)
    for k in range(STEPS):
        params, state = step({path: jnp.asarray(_grad(path, shape, k))}, state, params)
    np.save(out, np.asarray(params[path]))
    return {m: np.array(state[m][path]) for m in ("vr", "vc", "v")}


def _port(path, shape):
    """3 port updates on the leaf's layers; (the layers' params, moments)."""
    import torch
    from repro_torch.training import optimizer as O
    pattern, _ = LEAVES[path]
    names = [pattern.format(i) for i in range(shape[0])] if "{}" in pattern else [pattern]
    whole = torch.from_numpy(_param(path, shape))
    params = dict(zip(names, whole.unbind(0) if len(names) > 1 else [whole]))
    state = O.adafactor_init(params)
    for k in range(STEPS):
        g = torch.from_numpy(_grad(path, shape, k))
        grads = dict(zip(names, g.unbind(0) if len(names) > 1 else [g]))
        _, state = O.adafactor_update(grads, state, params, lr=LR, weight_decay=WD)
        del g, grads
    return ([params[n].numpy() for n in names],
            {m: state[m][path].numpy() for m in ("vr", "vc", "v")})


def _rel(got, want, rows=1 << 22):
    """max |got - want| / max |want|, over row blocks (no full-size float64)."""
    got, want = got.reshape(-1), want.reshape(-1)
    err = top = 0.0
    for i in range(0, want.size, rows):
        w = want[i:i + rows].astype(np.float64)
        err = max(err, float(np.max(np.abs(got[i:i + rows] - w))))
        top = max(top, float(np.max(np.abs(w))))
    return err / (top + 1e-30)


def leaf_main(path, out_dir):
    """One leaf, JAX then the port: the moments' shapes and errors, and each
    layer's param error and how far the update moved it, to
    ``out_dir/result.json``."""
    import warnings
    warnings.filterwarnings("ignore", "Some donated buffers were not usable")
    shape = LEAVES[path][1]
    want = _jax(path, shape, os.path.join(out_dir, "p.npy"))
    layers, got = _port(path, shape)
    res = {"jax_shapes": {m: list(want[m].shape) for m in want},
           "port_shapes": {m: list(got[m].shape) for m in got},
           "moment_err": {m: _rel(got[m], want[m]) for m in want}}
    want_p = np.load(os.path.join(out_dir, "p.npy"), mmap_mode="r")
    want_layers = list(want_p) if len(layers) > 1 else [want_p]
    start = _param(path, shape)
    res["layers"] = [{"shapes": [list(p.shape), list(w.shape)], "err": _rel(p, w),
                      "moved": _rel(w, start[i] if len(layers) > 1 else start)}
                     for i, (p, w) in enumerate(zip(layers, want_layers))]
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(res, f)


import pytest  # noqa: E402  (the leaf's process needs no pytest)


@pytest.mark.parametrize("path", list(LEAVES))
def test_adafactor_matches_jax_at_full_width(path, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, __file__, path, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=LEAF_TIMEOUT_S)
    assert run.returncode == 0, (run.stdout + run.stderr)[-6000:]
    with open(tmp_path / "result.json") as f:
        res = json.load(f)
    shape = LEAVES[path][1]
    want, got = res["jax_shapes"], res["port_shapes"]
    factored = len(shape) >= 2
    assert tuple(want["vr"]) == (shape[:-1] if factored else (1,))
    assert tuple(want["vc"]) == (shape[:-2] + shape[-1:] if factored else (1,))
    assert tuple(want["v"]) == ((1,) if factored else shape)
    for m in ("vr", "vc", "v"):
        assert got[m] == want[m], m
        assert res["moment_err"][m] < TOL, (m, res["moment_err"][m])
    assert len(res["layers"]) == (shape[0] if "{}" in LEAVES[path][0] else 1)
    for i, layer in enumerate(res["layers"]):
        assert layer["shapes"][0] == layer["shapes"][1]
        assert layer["err"] < TOL, (i, layer["err"])
        # the update moved the params by more than the tolerance
        assert layer["moved"] > 10 * TOL


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    leaf_main(sys.argv[1], sys.argv[2])
