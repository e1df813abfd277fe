"""Content keys of the port's workflow layer: the digests behind
``core/engines/local.py``'s ``_hash_value`` and ``cache_key`` (Algorithm 2's
artifact cache).

The reference keys a value by its pickle, falls back to its ``repr`` when
the pickle fails, keys a literal step argument by ``repr`` and a step's
function by its bytecode alone (``repro/core/engines/local.py:50-69``).
Each of these can hand a step another input's result: a tensor pickles by
identity, the ``repr`` of a tensor of more than 1,000 elements is
summarised, and the bytecode leaves out the constants, the closure and the
defaults. Here:

- every torch tensor, wherever it sits in a value, is keyed by its dtype,
  its shape and the sha256 of its bytes on the host;
- a value that does not pickle is walked through its dicts, lists and
  tuples: its tensors by content, each other part by its own pickle or,
  where that fails, its ``repr``. A value that holds no tensor keeps the
  reference's ``repr`` key byte for byte; one with a part that does not
  pickle and was seen to hold a tensor gets no key (``None``);
- a function is keyed by its code (``co_code``, ``co_names`` and
  ``co_consts``, nested code objects by the same rule), its closure cells'
  contents, ``__defaults__``, ``__kwdefaults__`` and the values of the
  module globals its code names (``co_names`` found in ``__globals__``,
  nested code included) that are plain data: numbers, strings, bytes,
  tensors, numpy arrays, and tuples, lists and dicts of those. A global
  module, function or class stays keyed by its name. A bound method is
  keyed by its function and by its ``__self__``'s content. A function in any of
  these that cannot be imported by name (a lambda, a closure) is keyed by
  the same rule, the pickler's memo standing guard against cycles; one that
  can, and a module, by name. Any other part that does not pickle gives no
  key.

``None`` means no reusable key: the caller then keys the step afresh, so it
never hits.
"""
from __future__ import annotations

import hashlib
import pickle
import sys
import types
from typing import Any, Optional, Tuple

import torch


def tensor_tag(t: torch.Tensor) -> str:
    """dtype, shape and the sha256 of the bytes of ``t`` on the host; equal
    for equal tensors whatever their device, storage, strides or offset."""
    t = t.detach().contiguous().cpu()
    # the bytes of any dtype, bf16 too (numpy has none)
    digest = hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()).hexdigest()
    return f"torch.Tensor {t.dtype} {tuple(t.shape)} {digest}"


class _Digest:
    """A file that hashes what is written to it."""

    def __init__(self):
        self.h = hashlib.sha256()

    def write(self, b):
        self.h.update(b)

    def key(self) -> str:
        return self.h.hexdigest()[:16]


class _EmptyCell:
    """Stands in for a closure cell not yet bound."""


def _importable(f: types.FunctionType) -> bool:
    obj = sys.modules.get(f.__module__)
    for part in f.__qualname__.split("."):
        obj = getattr(obj, part, None)
    return obj is f


def _plain_data(v: Any) -> bool:
    import numpy as np
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes,
                                   torch.Tensor, np.ndarray, np.generic)):
        return True
    if type(v) in (tuple, list):
        return all(_plain_data(x) for x in v)
    if type(v) is dict:
        return all(_plain_data(k) and _plain_data(x) for k, x in v.items())
    return False


def _names(code: types.CodeType) -> set:
    out = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            out |= _names(c)
    return out


def _function_parts(f: types.FunctionType) -> tuple:
    cells = []
    for cell in f.__closure__ or ():
        try:
            cells.append(cell.cell_contents)
        except ValueError:
            cells.append(_EmptyCell())
    g = f.__globals__
    data = tuple((n, g[n]) for n in sorted(_names(f.__code__))
                 if n in g and _plain_data(g[n]))
    return (f.__code__, tuple(cells), f.__defaults__, f.__kwdefaults__, data)


class _ContentPickler(pickle.Pickler):
    """Pickles tensors by content; with ``functions``, also functions (by
    ``_function_parts``, ``top`` always so), code objects and modules."""

    def __init__(self, file, functions: bool = False, top: Any = None):
        super().__init__(file)
        self.functions = functions
        self.top = top
        self.saw_tensor = False

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            self.saw_tensor = True
            return str, (tensor_tag(obj),)
        if not self.functions:
            return NotImplemented
        if isinstance(obj, types.FunctionType) and (obj is self.top
                                                    or not _importable(obj)):
            # the parts are the state, saved after the function is memoised:
            # a function in its own closure is a back-reference
            return str, ("function",), _function_parts(obj)
        if isinstance(obj, types.CodeType):
            return str, ("code",), (obj.co_code, obj.co_names, obj.co_consts)
        if isinstance(obj, types.ModuleType):
            return str, (f"module {obj.__name__}",)
        return NotImplemented


def _pickled(v: Any, functions: bool = False) -> Tuple[Optional[str], bool]:
    """(key of ``v``'s content pickle or None where it does not pickle,
    whether a tensor was met)."""
    out = _Digest()
    p = _ContentPickler(out, functions, top=v if functions else None)
    try:
        p.dump(v)
    except Exception:
        return None, p.saw_tensor
    return out.key(), p.saw_tensor


def _walk(v: Any, found: dict) -> str:
    """A text of ``v`` with its tensors and picklable parts by content,
    through dicts, lists and tuples; notes tensors and unkeyable parts."""
    if isinstance(v, torch.Tensor):
        found["tensor"] = True
        return tensor_tag(v)
    if type(v) is dict:
        return "{" + ", ".join(f"{k!r}: {_walk(x, found)}" for k, x in v.items()) + "}"
    if type(v) in (list, tuple):
        inner = ", ".join(_walk(x, found) for x in v)
        return f"[{inner}]" if type(v) is list else f"({inner},)"
    key, tensor = _pickled(v)
    found["tensor"] = found["tensor"] or tensor
    if key is None:
        # a part that does not pickle: by its repr, as the reference keys it,
        # unless it was seen to hold a tensor
        found["unkeyable"] = found["unkeyable"] or tensor
        return repr(v)
    return f"<pickle {key}>"


def digest(v: Any) -> Tuple[Optional[str], bool]:
    """(the content key of a value or None for no reusable key, whether it
    holds a tensor)."""
    key, tensor = _pickled(v)
    if key is not None:
        return key, tensor
    found = {"tensor": tensor, "unkeyable": False}
    text = _walk(v, found)
    out = _Digest()
    if not found["tensor"]:
        out.write(repr(v).encode())           # the reference's key, byte for byte
    elif found["unkeyable"]:
        return None, True
    else:
        out.write(text.encode())
    return out.key(), found["tensor"]


def function_digest(fn: Any) -> Optional[str]:
    """The content key of a step's function (a bound method by its function
    and its ``__self__``), or None where a part cannot be keyed by content."""
    if isinstance(fn, types.MethodType):
        out = _Digest()
        p = _ContentPickler(out, True, top=fn.__func__)
        try:
            p.dump((fn.__func__, fn.__self__))
        except Exception:
            return None
        return out.key()
    return _pickled(fn, functions=True)[0]
