"""The port's reprolint rules (RPL004, RPL006, RPL007).

Each rule states one convention of the port as a check; ``tests/
test_torch_analysis.py`` holds a caught/clean fixture pair per rule.

  RPL004  spec-safety: ``*Spec`` dataclasses frozen + JSON-round-trip safe
          (the reference's rule as it is)
  RPL006  device->host syncs inside a timed region of the port's launchers
          and ``chip_smoke.py`` (the reference's rule with torch's syncs)
  RPL007  a draw from torch's, NumPy's or the stdlib's global generator in
          the port (the torch counterpart of the reference's RPL001)

Not ported, being about JAX alone: RPL001 (a ``jax.random`` key reused;
the port passes ``torch.Generator``s, which advance as they draw, and
RPL007 checks that every draw names one), RPL002 (host numerics inside
jitted code; nothing is traced here), RPL003 (raw version-sensitive
``jax.*`` APIs) and RPL005 (CPU XLA loop-lowering shapes). RPL007 takes a
code of its own because the reference's RPL001 also scans this package: one
shared code would let an acknowledgement of one rule silence the other.
"""
from __future__ import annotations

import ast
from pathlib import PurePosixPath

from repro_torch.analysis.framework import ERROR, Rule, SourceModule, register

_JSON_ATOMS = frozenset({"str", "int", "float", "bool", "None"})
_JSON_CONTAINERS = frozenset({"tuple", "list", "dict", "Tuple", "List",
                              "Dict", "Optional", "Union"})


def _is_chip_smoke(path: str) -> bool:
    return PurePosixPath(path).name == "chip_smoke.py"


# --------------------------------------------------------------- RPL004 --

@register
class SpecSafety(Rule):
    """``*Spec`` dataclasses are the bit-for-bit reproducibility contract:
    frozen, JSON-safe fields, ``to_dict``/``from_dict`` round-trip. A
    mutable or non-serializable spec breaks replay-from-JSON silently."""
    code = "RPL004"
    name = "spec-safety"
    severity = ERROR
    description = "*Spec dataclass not frozen / not JSON-round-trip safe"

    def check(self, mod: SourceModule):
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name.endswith("Spec")):
                continue
            if not self._frozen_dataclass(mod, node):
                yield (node, f"{node.name} must be @dataclass(frozen=True) "
                       f"— specs are immutable reproducibility artifacts")
            methods = {n.name for n in node.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            for required in ("to_dict", "from_dict"):
                if required not in methods:
                    yield (node, f"{node.name} must define {required}() — "
                           f"specs round-trip through JSON")
            for field in node.body:
                if (isinstance(field, ast.AnnAssign)
                        and isinstance(field.target, ast.Name)
                        and not self._json_safe(field.annotation)):
                    ann = ast.unparse(field.annotation)
                    yield (field, f"{node.name}.{field.target.id}: {ann} is "
                           f"not JSON-safe; allowed: str/int/float/bool, "
                           f"tuple/list/dict of those, nested *Spec")

    @staticmethod
    def _frozen_dataclass(mod: SourceModule, node: ast.ClassDef) -> bool:
        for deco in node.decorator_list:
            if isinstance(deco, ast.Call):
                head = mod.resolve(deco.func)
                if head in ("dataclasses.dataclass", "dataclass"):
                    return any(k.arg == "frozen"
                               and isinstance(k.value, ast.Constant)
                               and k.value.value is True
                               for k in deco.keywords)
        return False

    @classmethod
    def _json_safe(cls, ann: ast.AST) -> bool:
        if isinstance(ann, ast.Constant):
            if ann.value is None or ann.value is Ellipsis:
                return True
            if isinstance(ann.value, str):        # stringified annotation
                try:
                    return cls._json_safe(
                        ast.parse(ann.value, mode="eval").body)
                except SyntaxError:
                    return False
            return False
        if isinstance(ann, ast.Name):
            return ann.id in _JSON_ATOMS or ann.id.endswith("Spec")
        if isinstance(ann, ast.Attribute):
            return ann.attr in _JSON_ATOMS or ann.attr.endswith("Spec")
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return cls._json_safe(ann.left) and cls._json_safe(ann.right)
        if isinstance(ann, ast.Subscript):
            head = ann.value
            name = head.id if isinstance(head, ast.Name) else (
                head.attr if isinstance(head, ast.Attribute) else None)
            if name not in _JSON_CONTAINERS:
                return False
            inner = ann.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            return all(cls._json_safe(e) for e in elts)
        return False


# --------------------------------------------------------------- RPL006 --

# Calls that copy device values to the host, and so wait for the device.
_SYNC_CALLS = frozenset({"numpy.asarray", "numpy.array"})
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
# The shared min-of-k helpers; functions handed to them by name are timed.
_TIMING_HELPERS = ("time_fn", "time_interleaved")


@register
class TimedRegionSync(Rule):
    """A device->host copy (``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``np.asarray``/``np.array`` of a tensor) inside a timed
    region bills the copy and the wait for every queued launch to the
    thing being measured. Copies belong outside the clock; inside it the
    one wait allowed is ``torch.cuda.synchronize`` (what ``timing.py``'s
    ``_sync_fn`` does), which is not flagged.

    Timed regions are (a) statements between ``t0 = time.perf_counter()``
    and the first statement that reads ``t0`` back, and (b) bodies of
    functions handed by name to ``time_fn`` / ``time_interleaved``. The
    rule scans the port's timed code: ``src/repro_torch/launch/`` and
    ``chip_smoke.py``."""
    code = "RPL006"
    name = "sync-in-timed-region"
    severity = ERROR
    description = "device→host sync inside a timed region"

    def check(self, mod: SourceModule):
        if not ("repro_torch/launch/" in mod.path or _is_chip_smoke(mod.path)):
            return
        timed_fns = self._handed_to_timers(mod)
        for body in self._stmt_lists(mod.tree):
            yield from self._perf_counter_regions(mod, body)
        for node in ast.walk(mod.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in timed_fns):
                for stmt in node.body:
                    yield from self._syncs(mod, stmt)

    @staticmethod
    def _stmt_lists(tree: ast.Module):
        """Every list of statements in the module (module body, function
        bodies, loop/branch/with bodies): perf_counter windows live within
        one such list."""
        yield tree.body
        for node in ast.walk(tree):
            for attr in ("body", "orelse", "finalbody"):
                block = getattr(node, attr, None)
                if (block and isinstance(block, list)
                        and not isinstance(node, ast.Module)
                        and isinstance(block[0], ast.stmt)):
                    yield block

    def _perf_counter_regions(self, mod: SourceModule, body):
        """Flag syncs between ``t = time.perf_counter()`` and the first
        statement reading ``t`` (the stop-the-clock statement)."""
        i = 0
        while i < len(body):
            started = self._perf_start(mod, body[i])
            i += 1
            if not started:
                continue
            while i < len(body) and not self._reads(body[i], started):
                yield from self._syncs(mod, body[i])
                i += 1

    @staticmethod
    def _perf_start(mod: SourceModule, stmt) -> str | None:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)):
            callee = mod.resolve(stmt.value.func)
            if callee in ("time.perf_counter", "time.monotonic", "time.time"):
                return stmt.targets[0].id
        return None

    @staticmethod
    def _reads(stmt, name: str) -> bool:
        return any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(stmt))

    def _handed_to_timers(self, mod: SourceModule) -> set[str]:
        """Names of module functions passed (anywhere in the argument
        expressions) to the shared timing helpers."""
        defined = {n.name for n in ast.walk(mod.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        handed: set[str] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = mod.resolve(node.func) or ""
            if callee.rsplit(".", 1)[-1] not in _TIMING_HELPERS:
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name) and sub.id in defined:
                        handed.add(sub.id)
        return handed

    def _syncs(self, mod: SourceModule, stmt):
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args):
                yield (node, f".{node.func.attr}() inside a timed region copies "
                       f"to the host and waits for the device on the clock; "
                       f"synchronise, stop the clock, then copy")
            callee = mod.resolve(node.func)
            if callee in _SYNC_CALLS:
                yield (node, f"{callee}() inside a timed region copies "
                       f"device values to host on the clock; move the "
                       f"conversion outside the timed window")


# --------------------------------------------------------------- RPL007 --

# torch functions that draw from the default generator unless handed one
_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "rand_like",
                          "randn_like", "randint_like", "normal", "bernoulli",
                          "multinomial", "poisson"})
# in-place samplers of a tensor, likewise
_INPLACE_DRAWS = frozenset({"normal_", "uniform_", "random_", "exponential_",
                            "bernoulli_", "geometric_", "cauchy_", "log_normal_"})
# calls that (re)seed or read torch's global generators
_TORCH_SEEDS = frozenset({"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                          "torch.cuda.manual_seed_all", "torch.cuda.seed",
                          "torch.cuda.seed_all", "torch.random.manual_seed",
                          "torch.random.seed"})
# numpy.random names that make an explicit generator rather than draw
_NUMPY_EXPLICIT = frozenset({"default_rng", "Generator", "SeedSequence"})


@register
class GlobalGeneratorDraw(Rule):
    """Every random draw in the port comes from an explicit, seeded
    generator (a ``torch.Generator`` handed down as ``generator=``, a
    ``np.random.default_rng(seed)``), so a run is a function of its seeds.
    A draw from torch's, NumPy's or the stdlib's global generator depends on
    whatever drew before it, in this module or any other.

    Flagged, in ``src/repro_torch/`` and ``chip_smoke.py``:
      * ``torch.rand/randn/randint/randperm/rand_like/randn_like/
        randint_like/normal/bernoulli/multinomial/poisson`` without a
        ``generator=`` keyword;
      * the in-place ``.normal_/.uniform_/.random_/.exponential_/
        .bernoulli_/.geometric_/.cauchy_/.log_normal_()`` without one;
      * ``torch.manual_seed``, ``torch.seed`` and ``torch.cuda.manual_seed*``;
      * ``numpy.random.<draw>`` of the module-level generator (allowed:
        ``default_rng(seed)``, ``Generator``, ``SeedSequence``; an unseeded
        ``default_rng()`` is flagged) and stdlib ``random.<draw>``.

    What it cannot see: ``generator=g`` where ``g`` may be ``None`` at run
    time (as the optional ``generator`` of the ``nn`` constructors), which
    falls back to the global generator."""
    code = "RPL007"
    name = "global-generator-draw"
    severity = ERROR
    description = "random draw from a global generator (torch, numpy, random)"

    def check(self, mod: SourceModule):
        if not ("repro_torch/" in mod.path or _is_chip_smoke(mod.path)):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            has_gen = any(k.arg == "generator" for k in node.keywords)
            callee = mod.resolve(node.func) or ""
            head, _, last = callee.rpartition(".")
            if head == "torch" and last in _TORCH_DRAWS and not has_gen:
                yield (node, f"{callee}() without generator= draws from torch's "
                       f"global generator; pass a seeded torch.Generator")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_DRAWS and not has_gen):
                yield (node, f".{node.func.attr}() without generator= draws from "
                       f"torch's global generator; pass a seeded torch.Generator")
            elif callee in _TORCH_SEEDS:
                yield (node, f"{callee}() sets or reads torch's global generator; "
                       f"seed a torch.Generator and pass it down instead")
            elif head == "numpy.random" and (last not in _NUMPY_EXPLICIT or (
                    last == "default_rng" and not node.args and not node.keywords)):
                yield (node, f"{callee}() draws from NumPy's global (or an "
                       f"unseeded) generator; use np.random.default_rng(seed)")
            elif head == "random" and last != "Random":
                yield (node, f"random.{last}() draws from the stdlib's global "
                       f"generator; use random.Random(seed) or "
                       f"np.random.default_rng(seed)")
