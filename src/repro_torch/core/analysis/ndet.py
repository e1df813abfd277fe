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
    np.random.rand, numpy.random.choice, …) and for draws from torch's
    global generator made through the torch module: ``torch.rand*``,
    ``torch.randint*``, ``torch.randn*``, ``torch.randperm``,
    ``torch.normal``, ``torch.bernoulli``, ``torch.multinomial``,
    ``torch.poisson``, ``torch.seed`` and the ``torch.nn.init.*_``
    initialisers that draw (not ``zeros_``, ``ones_``, ``constant_``,
    ``eye_``, ``dirac_``). ``jax.random`` is excluded: its functions are
    pure given an explicit key. ``_scan`` excuses a draw given an explicit
    ``generator=``."""
    parts = dotted.split(".")
    if parts[0] == "jax":
        return False
    if parts[0] == "torch":
        if parts[1:-1] == ["nn", "init"]:
            return parts[-1].endswith("_") and parts[-1] not in (
                "zeros_", "ones_", "constant_", "eye_", "dirac_")
        if len(parts) == 2 and parts[1] in (
                "rand", "rand_like", "randint", "randint_like", "randn", "randn_like",
                "randperm", "normal", "bernoulli", "multinomial", "poisson", "seed"):
            return True
    # "random" must appear as a module segment, not as the final call name
    # (rng.random() on a seeded generator is fine and unresolvable anyway)
    return "random" in parts[:-1] or (parts[0] == "random" and len(parts) > 1)


def _scan(tree: ast.AST) -> Tuple[str, ...]:
    """As the JAX package's pass, and also: a tensor's in-place draws
    (``x.uniform_()``, ``.normal_()``, ``.random_()``, ``.bernoulli_()``,
    ``.exponential_()``, ``.geometric_()``, ``.log_normal_()``,
    ``.cauchy_()``) come from torch's global generator; ``manual_seed(x)``
    and ``manual_seed_all(x)`` (on the torch module, ``torch.cuda`` or a
    generator) seed; a draw given ``generator=`` (not None) is not
    flagged."""
    findings = []
    seeded = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        given = node.args or node.keywords
        if method in ("manual_seed", "manual_seed_all") and given:
            seeded = True                        # torch.manual_seed(x), g.manual_seed(x)
            continue
        if any(k.arg == "generator" and not (isinstance(k.value, ast.Constant)
                                             and k.value.value is None)
               for k in node.keywords):
            continue                             # a draw from its own generator
        if method in ("uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                      "geometric_", "log_normal_", "cauchy_") and not (
                dotted and dotted.startswith("torch.nn.init.")):
            findings.append((dotted or f"(...).{method}", True))   # a tensor's draw
            continue
        if not dotted:
            continue
        last = dotted.split(".")[-1]
        if last in _SEED_SUFFIXES and given:
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
