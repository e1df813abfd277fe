"""AST nondeterminism pass over step functions (feeds diagnostic CLR007).

A ``cacheable=True`` step whose fn draws from an unseeded RNG, the wall
clock, or uuid/urandom produces different artifacts on identical inputs —
exactly what the content-addressed cache (and the chunk-granular stream
cache) cannot detect at runtime. This pass inspects the *source* of the
step fn: it flags value-producing nondeterministic calls unless a seeding
call with an explicit argument (``random.seed(x)``,
``np.random.default_rng(x)``, ``jax.random.PRNGKey(x)``…) appears in the
same function.

The pass is deliberately conservative about what it cannot resolve:
methods on local variables (``rng.normal(...)``), lambdas whose source
does not parse standalone, and builtins without retrievable source are
all skipped — zero false positives beats completeness here. Results are
memoized per ``fn.__code__`` object, so linting thousands of workflows
that share step functions (the fleet-submission hot path) parses each
distinct function body exactly once.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Dict, Optional, Tuple

# value-producing wall-clock / uniqueness calls: nondeterministic no
# matter what was seeded (time.sleep is NOT here — it produces no value)
_CLOCK_SUFFIXES = ("time.time", "time.time_ns", "time.monotonic",
                   "time.monotonic_ns", "time.perf_counter",
                   "time.perf_counter_ns", "datetime.now",
                   "datetime.utcnow", "datetime.today")
_UNIQUE_SUFFIXES = ("uuid.uuid1", "uuid.uuid4", "os.urandom",
                    "secrets.token_bytes", "secrets.token_hex",
                    "secrets.token_urlsafe", "secrets.randbelow")

# calls that *seed* an RNG when given an explicit argument
_SEED_SUFFIXES = ("default_rng", "PRNGKey", "seed", "RandomState",
                  "Random")
# RNG constructors that are nondeterministic when called with NO argument
_RNG_CONSTRUCTORS = ("default_rng", "RandomState", "Random")

_memo: Dict[object, Tuple[str, ...]] = {}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_rng_module_call(dotted: str) -> bool:
    """True for draws straight off a random *module* (random.random,
    np.random.rand, numpy.random.choice, …). ``jax.random`` is excluded:
    its functions are pure given an explicit key."""
    parts = dotted.split(".")
    if parts[0] == "jax":
        return False
    # "random" must appear as a module segment, not as the final call name
    # (rng.random() on a seeded generator is fine and unresolvable anyway)
    return "random" in parts[:-1] or (parts[0] == "random" and len(parts) > 1)


def _scan(tree: ast.AST) -> Tuple[str, ...]:
    findings = []
    seeded = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if not dotted:
            continue
        last = dotted.split(".")[-1]
        if last in _SEED_SUFFIXES and (node.args or node.keywords):
            seeded = True
            continue
        if any(dotted == s or dotted.endswith("." + s)
               for s in _CLOCK_SUFFIXES + _UNIQUE_SUFFIXES):
            findings.append((dotted, False))     # never excused by seeding
        elif _is_rng_module_call(dotted) or (last in _RNG_CONSTRUCTORS
                                             and not node.args
                                             and not node.keywords):
            findings.append((dotted, True))      # excused if fn seeds
    return tuple(f"{name}()" for name, excusable in findings
                 if not (excusable and seeded))


def nondeterminism_findings(fn) -> Tuple[str, ...]:
    """Nondeterministic call sites in ``fn``'s own source (non-transitive).

    Returns a tuple of call descriptions, empty when the function is
    clean or its source cannot be inspected.
    """
    code = getattr(fn, "__code__", None)
    if code is None:
        return ()
    hit = _memo.get(code)
    if hit is not None:
        return hit
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, ValueError):
        _memo[code] = ()
        return ()
    out = _scan(tree)
    _memo[code] = out
    return out
