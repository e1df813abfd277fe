"""One file a model family, found by the family's name (``configs/<c>.json``'s
``model.family``): ``families/<family>.py``. Each gives

- ``body(ref, tree, h)``: the hidden states after the family's layers, from
  the embedded tokens ``h``, built from the plain layers of
  ``reference.Reference`` ``ref`` over the parameter tree ``tree``;
- ``forward_products(m, B, S)``: the product FLOPs of those layers in one
  forward over (B, S) tokens, with no recompute (``work.py`` adds the head).

A configuration of a new family is added with its file here, and nothing
else of the benchmark changes."""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def load(family: str) -> ModuleType:
    if not (HERE / f"{family}.py").is_file():
        raise ValueError(f"no file portbench/families/{family}.py for family {family!r}")
    return importlib.import_module(f"portbench.families.{family}")
