"""Prong 2: AST determinism lint over ``src/repro_torch/``.

Byte-identical replay/resume is the property every fault-tolerance,
streaming, and cross-system comparison test rests on.  These rules catch
the ways it historically regresses:

- ``wall-clock`` (error): ``time.time``/``monotonic``/``perf_counter``/
  ``datetime.now`` calls in *sim-domain* modules — simulated components
  must consume injected clocks (scheduler ``now=``, tracer dual clocks),
  never the host's.  The observability layer (the tracer/metrics
  whitelist) and the real-network socket transport are exempt.
- ``sleep-in-sim`` (error): ``time.sleep`` in sim-domain modules —
  simulated latency must be priced, not slept.
- ``unseeded-rng`` (error): legacy ``np.random.*`` / stdlib ``random.*``
  module-level draws (process-global hidden state), and
  ``np.random.default_rng()`` / ``random.Random()`` with no seed; and
  torch's global generator: ``torch.rand`` / ``randn`` / ``randint`` /
  ``randperm`` / their ``*_like`` / ``normal`` / ``bernoulli`` /
  ``multinomial`` and the in-place ``normal_`` / ``uniform_`` /
  ``bernoulli_`` / ``random_`` / ``exponential_`` with no ``generator=``,
  ``torch.manual_seed`` (and its CUDA forms), and a ``torch.Generator()``
  that is never seeded.
- ``unordered-iteration`` (warning): iterating a set literal /
  comprehension / ``set(...)`` call directly — order is
  hash-randomized across processes; wrap in ``sorted()``.
- ``json-unsorted-keys`` (warning): ``json.dump(s)`` without
  ``sort_keys`` in persistence modules — insertion order is
  deterministic *today*, but any re-keying silently changes committed
  bytes (and CRCs, per the PR 6/8 framing conventions).
- ``binary-no-crc`` (warning): a persistence module that ``.write()``\\ s
  ``struct.pack`` / ``.tobytes()`` payloads without referencing a CRC
  anywhere — persisted binary formats carry checksums in this repo.

A finding is suppressed by a waiver comment on its line or the line
above::

    t0 = time.perf_counter()  # staticcheck: ok=wall-clock display only

Accepted findings without a code-site waiver live in the committed
``STATICCHECK_torch_baseline.json`` with a reason string.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.staticcheck.findings import Finding

# sim-domain: components whose time/ordering is simulated and replayed.
# observability (tracer/metrics) and kernels/models are deliberately out.
SIM_DOMAIN = ("src/repro_torch/core/", "src/repro_torch/fleet/",
              "src/repro_torch/transport/", "src/repro_torch/streaming/",
              "src/repro_torch/experiments/", "src/repro_torch/runtime/",
              "src/repro_torch/data/", "src/repro_torch/launch/")

# modules that persist replayable artifacts (JSONL, checkpoints, rings)
PERSIST_DOMAIN = ("src/repro_torch/runtime/", "src/repro_torch/transport/",
                  "src/repro_torch/streaming/", "src/repro_torch/fleet/",
                  "src/repro_torch/observability/",
                  "src/repro_torch/experiments/", "src/repro_torch/data/")

# the real-network transport runs against actual sockets: wall-clock and
# sleeps there are not simulation state
REALTIME_FILES = ("src/repro_torch/transport/socket_transport.py",)

WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
SLEEP_CALLS = {"time.sleep"}
NP_LEGACY_RNG = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "normal", "uniform",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
    "gamma", "lognormal", "laplace", "multivariate_normal",
}
STDLIB_RNG = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "getrandbits", "randbytes",
}
JSON_DUMP_CALLS = {"json.dump", "json.dumps"}
# torch's global generator: draws that take generator= (the counterpart of
# NP_LEGACY_RNG), in-place draws on a tensor, and seeding it
TORCH_RNG = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial",
}
TORCH_INPLACE_RNG = {"normal_", "uniform_", "bernoulli_", "random_",
                     "exponential_"}
TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.random.manual_seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}

_WAIVER_RE = re.compile(r"#\s*staticcheck:\s*ok=([A-Za-z0-9_,-]+)")


def _waivers(source: str) -> Dict[int, Set[str]]:
    """line number -> set of waived rule ids (or {"all"})."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m:
            out[i] = set(m.group(1).split(","))
    return out


def _in_domain(path: str, prefixes: Sequence[str]) -> bool:
    return any(path.startswith(p) for p in prefixes)


class _ModuleLint(ast.NodeVisitor):
    """One file's lint pass: import-aware call resolution + rule checks."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.findings: List[Finding] = []
        self.waivers = _waivers(source)
        self.aliases: Dict[str, str] = {}       # local name -> module path
        self.from_imports: Dict[str, str] = {}  # local name -> module.attr
        self.scope: List[str] = []
        self.ordinals: Dict[Tuple[str, str, str], int] = {}
        self.sim = (_in_domain(path, SIM_DOMAIN)
                    and path not in REALTIME_FILES)
        self.persist = _in_domain(path, PERSIST_DOMAIN)
        self.has_crc = bool(re.search(r"crc", source, re.IGNORECASE))
        # torch.Generator() calls: seeded in a chain, the names they are
        # bound to, the names seeded anywhere in the module, and the
        # unchained ones (node, context, bound name)
        self.gen_chained: Set[int] = set()
        self.gen_bound: Dict[int, str] = {}
        self.gen_seeded: Set[str] = set()
        self.gen_made: List[Tuple[ast.AST, str, Optional[str]]] = []

    # -- bookkeeping --------------------------------------------------------

    @property
    def context(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _waived(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            rules = self.waivers.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False

    def _emit(self, rule: str, severity: str, node: ast.AST, message: str,
              key: str, context: Optional[str] = None):
        line = getattr(node, "lineno", 0)
        if self._waived(rule, line):
            return
        context = self.context if context is None else context
        okey = (rule, context, key)
        n = self.ordinals.get(okey, 0)
        self.ordinals[okey] = n + 1
        self.findings.append(Finding(
            rule=rule, severity=severity, path=self.path, line=line,
            message=message, context=context, detail=f"{key}#{n}"))

    def _resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a call target, resolved through imports."""
        if isinstance(node, ast.Name):
            if node.id in self.from_imports:
                return self.from_imports[node.id]
            if node.id in self.aliases:
                return self.aliases[node.id]
            return None
        if isinstance(node, ast.Attribute):
            base = self._resolve(node.value)
            if base is None:
                return None
            return f"{base}.{node.attr}"
        return None

    # -- visitors -----------------------------------------------------------

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and node.level == 0:
            for a in node.names:
                self.from_imports[a.asname or a.name] = (
                    f"{node.module}.{a.name}")
        self.generic_visit(node)

    def _visit_scoped(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_scoped
    visit_AsyncFunctionDef = _visit_scoped
    visit_ClassDef = _visit_scoped

    def visit_Assign(self, node: ast.Assign):
        if len(node.targets) == 1 and isinstance(node.value, ast.Call):
            self.gen_bound[id(node.value)] = ast.unparse(node.targets[0])
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        target = self._resolve(node.func)
        if target is not None:
            self._check_call(node, target)
        # .write() receivers are usually local file objects, which the
        # import resolver can't name — check them unconditionally; so are
        # the tensors of in-place draws
        self._check_write(node)
        self._check_torch_method(node)
        self.generic_visit(node)

    def finish(self):
        """Module-level rules that need the whole file: a torch.Generator()
        never seeded."""
        for node, context, name in self.gen_made:
            if name is None or name not in self.gen_seeded:
                self._emit("unseeded-rng", "error", node,
                           "torch.Generator() that is never seeded draws "
                           "from a default seed — call .manual_seed(seed) "
                           "on it", "torch.Generator", context)

    def visit_For(self, node: ast.For):
        self._check_iteration(node.iter)
        self.generic_visit(node)

    def _comp(self, node):
        for gen in node.generators:
            self._check_iteration(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _comp
    visit_SetComp = _comp
    visit_DictComp = _comp
    visit_GeneratorExp = _comp

    # -- rules --------------------------------------------------------------

    def _check_call(self, node: ast.Call, target: str):
        if self.sim and target in WALL_CLOCK_CALLS:
            self._emit("wall-clock", "error", node,
                       f"{target}() in sim-domain module — use the "
                       "injected clock (scheduler now= / tracer)", target)
        if self.sim and target in SLEEP_CALLS:
            self._emit("sleep-in-sim", "error", node,
                       "time.sleep() in sim-domain module — simulated "
                       "latency must be priced, not slept", target)
        parts = target.split(".")
        if (len(parts) == 3 and parts[0] == "numpy"
                and parts[1] == "random" and parts[2] in NP_LEGACY_RNG):
            self._emit("unseeded-rng", "error", node,
                       f"np.random.{parts[2]}() draws from the "
                       "process-global legacy RNG — thread a seeded "
                       "Generator (np.random.default_rng(seed))", target)
        if target == "numpy.random.default_rng" and not (node.args
                                                         or node.keywords):
            self._emit("unseeded-rng", "error", node,
                       "np.random.default_rng() without a seed is "
                       "OS-entropy seeded — pass an explicit seed", target)
        if (len(parts) == 2 and parts[0] == "random"
                and parts[1] in STDLIB_RNG):
            self._emit("unseeded-rng", "error", node,
                       f"random.{parts[1]}() draws from the process-"
                       "global RNG — use a seeded random.Random(seed)",
                       target)
        if target == "random.Random" and not (node.args or node.keywords):
            self._emit("unseeded-rng", "error", node,
                       "random.Random() without a seed is OS-entropy "
                       "seeded — pass an explicit seed", target)
        if (len(parts) == 2 and parts[0] == "torch"
                and parts[1] in TORCH_RNG
                and not any(kw.arg == "generator" for kw in node.keywords)):
            self._emit("unseeded-rng", "error", node,
                       f"torch.{parts[1]}() without generator= draws from "
                       "torch's process-global generator — pass a seeded "
                       "torch.Generator", target)
        if target in TORCH_GLOBAL_SEED:
            self._emit("unseeded-rng", "error", node,
                       f"{target}() seeds torch's process-global generator, "
                       "which every caller in the process shares — thread "
                       "a seeded torch.Generator instead", target)
        if target == "torch.Generator" and id(node) not in self.gen_chained:
            self.gen_made.append((node, self.context,
                                  self.gen_bound.get(id(node))))
        if self.persist and target in JSON_DUMP_CALLS:
            if not any(kw.arg == "sort_keys" for kw in node.keywords):
                self._emit("json-unsorted-keys", "warning", node,
                           f"{target}() without sort_keys in a "
                           "persistence module — key order becomes part "
                           "of the committed bytes", target)
    def _check_torch_method(self, node: ast.Call):
        if not isinstance(node.func, ast.Attribute):
            return
        attr, recv = node.func.attr, node.func.value
        if attr == "manual_seed":
            if (isinstance(recv, ast.Call)
                    and self._resolve(recv.func) == "torch.Generator"):
                self.gen_chained.add(id(recv))
            elif not isinstance(recv, ast.Call):
                self.gen_seeded.add(ast.unparse(recv))
        if (attr in TORCH_INPLACE_RNG
                and not any(kw.arg == "generator" for kw in node.keywords)):
            self._emit("unseeded-rng", "error", node,
                       f".{attr}() without generator= draws from torch's "
                       "process-global generator — pass a seeded "
                       "torch.Generator", attr)

    def _check_write(self, node: ast.Call):
        if (self.persist and not self.has_crc
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write" and node.args):
            if self._binary_payload(node.args[0]):
                self._emit("binary-no-crc", "warning", node,
                           "binary payload written in a module with no "
                           "CRC coverage — persisted binary formats "
                           "carry checksums (transport.framing.crc32)",
                           "write")

    def _binary_payload(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                t = self._resolve(sub.func)
                if t == "struct.pack":
                    return True
                if (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "tobytes"):
                    return True
        return False

    def _check_iteration(self, it: ast.AST):
        unordered = (isinstance(it, (ast.Set, ast.SetComp))
                     or (isinstance(it, ast.Call)
                         and isinstance(it.func, ast.Name)
                         and it.func.id == "set"
                         and it.func.id not in self.from_imports
                         and it.func.id not in self.aliases))
        if unordered:
            self._emit("unordered-iteration", "warning", it,
                       "iterating a set directly — order is hash-"
                       "randomized across processes; wrap in sorted()",
                       "set")


def lint_file(path: str, repo_root: str) -> List[Finding]:
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="syntax-error", severity="error", path=rel,
                        line=e.lineno or 0, message=str(e),
                        context="<module>", detail="parse")]
    lint = _ModuleLint(rel, source)
    lint.visit(tree)
    lint.finish()
    return lint.findings


def lint_source(source: str, rel_path: str) -> List[Finding]:
    """Lint an in-memory snippet as if it lived at ``rel_path`` (tests)."""
    tree = ast.parse(source)
    lint = _ModuleLint(rel_path, source)
    lint.visit(tree)
    lint.finish()
    return lint.findings


def lint_tree(repo_root: str,
              subdirs: Sequence[str] = ("src/repro_torch",)
              ) -> List[Finding]:
    findings: List[Finding] = []
    for sub in subdirs:
        base = os.path.join(repo_root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fname),
                                              repo_root))
    return findings
