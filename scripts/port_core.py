"""Keeps ``src/repro_torch/core`` a copy of the JAX package's ``src/repro/core``.

    python scripts/port_core.py           # write the copy
    python scripts/port_core.py --check   # exit 1 where the copy has drifted

Every file of ``src/repro/core`` is copied with one rewrite, the package
prefix ``repro.core`` -> ``repro_torch.core`` (imports, lazy imports inside
functions and docstrings alike); a change-history tag, ``(PR <n>)`` in a
docstring, is dropped, as the port's files carry none. The functions named
in ``DIVERGENT`` are the port's own: where the port's file already defines
one, the copy keeps the port's definition in its place, and everything
around it is the original's.
``tests/test_torch_workflow.py`` holds the copy equal to what this script
writes. The script reads both packages as text and imports neither.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
ORIGINAL = ROOT / "src" / "repro" / "core"
PORT = ROOT / "src" / "repro_torch" / "core"

# The torch seams, by file under core/ and qualified name: content hashing of
# tensors, content keys of a step's function and literal arguments, the
# port's checkpoint session, the profiled call without an AOT phase, the
# CUDA fence, the CUDA memory reading; and the port's payload of the Fig. 8
# tuner.
DIVERGENT: Dict[str, Tuple[str, ...]] = {
    "engines/local.py": ("_hash_value", "cache_key", "LocalEngine._ckpt_session",
                         "LocalEngine._profiled_invoke", "_block_until_ready",
                         "_device_memory_bytes"),
    "autotune.py": ("train_real_model",),
}

_PREFIX = re.compile(r"\brepro\.core\b")
_HISTORY_TAG = re.compile(r" \(PR \d+\)")


def rewrite(text: str) -> str:
    """The original's text with the package prefix rewritten and its
    change-history tags dropped."""
    return _HISTORY_TAG.sub("", _PREFIX.sub("repro_torch.core", text))


def _functions(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """(qualified name, node) of the module's functions and its classes'
    methods."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


def spans(text: str, names) -> Dict[str, Tuple[int, int]]:
    """{name: (first line, last line)}, 0-based and inclusive, of each named
    function, decorators included."""
    found = {}
    for qual, node in _functions(ast.parse(text)):
        if qual in names:
            first = min([node.lineno] + [d.lineno for d in node.decorator_list]) - 1
            found[qual] = (first, node.end_lineno - 1)
    missing = set(names) - set(found)
    if missing:
        raise KeyError(f"not defined: {sorted(missing)}")
    return found


def render(original: str, port: str, names=()) -> str:
    """The port's file: ``original`` rewritten, with each function of
    ``names`` taken from ``port``."""
    text = rewrite(original)
    if not names:
        return text
    lines = text.splitlines(keepends=True)
    port_lines = port.splitlines(keepends=True)
    ours = spans(port, names)
    # replace from the bottom so that earlier spans keep their line numbers
    for name, (a, b) in sorted(spans(text, names).items(), key=lambda kv: -kv[1][0]):
        pa, pb = ours[name]
        lines[a:b + 1] = port_lines[pa:pb + 1]
    return "".join(lines)


def expected() -> Dict[Path, str]:
    """{port path: text the copy should hold} for every file of the original."""
    out = {}
    for src in sorted(ORIGINAL.rglob("*")):
        if not src.is_file() or "__pycache__" in src.parts:
            continue
        rel = src.relative_to(ORIGINAL).as_posix()
        dst = PORT / rel
        names = DIVERGENT.get(rel, ())
        port = dst.read_text() if (names and dst.exists()) else ""
        out[dst] = render(src.read_text(), port, names if port else ())
    return out


def drifted() -> List[Path]:
    return [p for p, text in expected().items()
            if not p.exists() or p.read_text() != text]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="write nothing; exit 1 if a file differs")
    args = ap.parse_args(argv)
    if args.check:
        bad = drifted()
        for p in bad:
            print(f"drifted: {p.relative_to(ROOT)}")
        return 1 if bad else 0
    for p, text in expected().items():
        p.parent.mkdir(parents=True, exist_ok=True)
        if not p.exists() or p.read_text() != text:
            p.write_text(text)
            print(f"wrote {p.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
