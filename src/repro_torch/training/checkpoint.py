"""Versioned checkpoints in the JAX package's on-disk layout.

Port of ``repro/training/checkpoint.py``: one ``.npy`` per leaf of the JAX
train-state tree, in its stacked layout, named by its ``/``-joined path with
``/`` -> ``__``, plus ``manifest.json`` (step, time, and each leaf's path,
file, shape and dtype), written under ``.tmp_step_<n>`` and renamed to
``step_<n>`` to publish it. A checkpoint of either package restores into
the other (``bridge`` maps the trees).

bfloat16 leaves are written as the JAX package writes them: two raw bytes
per value (``np.save`` stores numpy's bfloat16 as ``'<V2'``) and dtype
``"bfloat16"`` in the manifest. ``restore`` reads them back by the
manifest's dtype, the bytes viewed as int16 and then as bfloat16, so a
checkpoint of the configured bf16 model restores; the JAX package's own
``restore`` hands such a leaf back as ``V2`` bytes that JAX rejects.

``restore()`` returns ``{path: CPU tensor}``; ``restore(like=state)`` copies
the leaves into a port train state in place and returns it.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import bridge


def _flat(state: Dict[str, Any]) -> Dict[str, Any]:
    """A port train state, a nested tree or a flat {path: leaf} -> flat."""
    if isinstance(state.get("params"), nn.Module):
        return bridge.state_to_flat(state)
    return bridge.flatten(state)


def _encode(leaf):
    """-> (array to np.save, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, cache=None):
        """``cache``: any object with ``offer(key, value, *, compute_time_s,
        producer, nbytes)``, told of each saved step."""
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.cache = cache
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> Path:
        d = self.root / f"step_{step:08d}"
        if d.exists():                         # idempotent (async + sync race)
            return d
        tmp = self.root / f".tmp_step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        flat = _flat(state)
        manifest: Dict[str, Any] = {"step": step, "leaves": [], "time": time.time()}
        for path in sorted(flat, key=lambda p: p.split("/")):   # JAX's leaf order
            name = path.replace("/", "__")
            arr, dtype = _encode(flat[path])
            np.save(tmp / f"{name}.npy", arr)
            manifest["leaves"].append({"path": path, "file": f"{name}.npy",
                                       "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        tmp.rename(d)                          # atomic publish
        self._gc()
        if self.cache is not None:
            self.cache.offer(f"ckpt:{self.root.name}:{step}", str(d),
                             compute_time_s=1.0, producer=f"ckpt-{step}",
                             nbytes=sum(f.stat().st_size for f in d.glob("*.npy")))
        return d

    def async_save(self, step: int, state: Dict[str, Any]) -> threading.Thread:
        """Snapshot to host memory (blocking copies, so later in-place
        updates do not reach it), then write in a background thread."""
        if isinstance(state.get("params"), nn.Module):
            flat = bridge.state_to_flat(state)            # copies already
        else:
            flat = {k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                        else np.array(v, copy=True)) for k, v in _flat(state).items()}
        self.wait()
        t = threading.Thread(target=self.save, args=(step, flat), daemon=True)
        t.start()
        self._pending = t
        return t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.root.glob("step_*"))
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Optional[Dict[str, Any]] = None):
        """{path: CPU tensor} of ``step`` (default the latest), or, with a
        port train state ``like``, that state with the leaves copied in."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {m["path"]: _decode(np.load(d / m["file"]), m["dtype"])
                for m in manifest["leaves"]}
        return flat if like is None else bridge.load_flat(like, flat)

    def _gc(self) -> None:
        steps = sorted(self.root.glob("step_*"))
        for p in steps[: max(0, len(steps) - self.keep)]:
            for f in p.glob("*"):
                f.unlink()
            p.rmdir()


class StepCheckpointSession:
    """The ``ckpt=`` handle a checkpoint-wired workflow step receives, as in
    the JAX package: a veneer over a ``CheckpointManager`` shared across the
    step's retry attempts. The step probes ``latest_step()`` on entry,
    restores and continues if an earlier attempt left progress, and calls
    ``save(step, state)`` as it goes; ``tick``/``save`` are the interruption
    points where a runtime may deliver a kill, before the state persists.
    """

    def __init__(self, manager: CheckpointManager,
                 on_tick: Optional[Callable[[int], None]] = None):
        self.manager = manager
        self._on_tick = on_tick
        self.resumed_from: Optional[int] = None

    def latest_step(self) -> Optional[int]:
        return self.manager.latest_step()

    def restore(self, step: Optional[int] = None, **kw):
        out = self.manager.restore(step=step, **kw)
        self.resumed_from = (step if step is not None
                             else self.manager.latest_step())
        return out

    def tick(self, iteration: int) -> None:
        """Announce an iteration boundary (an interruption point)."""
        if self._on_tick is not None:
            self._on_tick(iteration)

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        self.tick(step)
        return self.manager.save(step, state)
