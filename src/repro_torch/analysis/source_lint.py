"""Repo-rule AST lint over ``src/repro_torch``, the port's counterpart of
``repro.analysis.source_lint``.

* ``plan-widen-coverage`` — every :class:`DispatchPlan` *id* field (by the
  naming convention: suffix ``_ids`` / ``_slots`` / ``_src`` / ``_rows`` /
  ``_idx``, plus ``bkt_head``) must be covered by ``widen()``: named as a
  keyword of a ``_replace`` call in it, or listed in a module-level tuple
  it reads (``_ID_FIELDS`` and the tuples spliced into it).
* ``plan-rebuild-coverage`` — every field must be produced on the build
  path: a keyword of a ``DispatchPlan(...)`` call or a key of a dict the
  layout helpers emit in ``core/plan.py`` or the mesh partition emits in
  ``distributed/plan_shard.py`` (the path ``plan_from_state`` replays).
* ``plan-spec-coverage`` — every field must be named as a keyword of a
  ``DispatchPlan(...)`` or ``_replace`` call in
  ``models/dit.engine_state_specs`` (a field without a logical spec has no
  layout for :mod:`repro_torch.launch.steps` to lay it out by).
* ``module-dict-cache`` — a module-level ``NAME = {}``/``dict()`` whose
  name contains ``CACHE`` or ``MEMO`` is an unbounded cache; bound it
  (``functools.lru_cache``).
* ``id-keyed-cache`` — a cache keyed by ``id(obj)`` aliases freed
  addresses.  Flagged when a simple statement both calls ``id`` (directly
  or through a local assigned from it) and touches a ``CACHE``/``MEMO``
  store; a transient local dict keyed by ``id`` stays legal.

Not applicable, with the reason: ``jit-in-traced-body`` (the port jits
nothing and has no traced bodies).

Entry points: :func:`lint_sources` (the whole tree) and :func:`lint_source`
(one in-memory module, the generic rules: what the fixtures use).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Tuple

__all__ = ["lint_sources", "lint_source", "LintHit", "ID_FIELD_SUFFIXES", "plan_fields",
           "is_id_field"]

ID_FIELD_SUFFIXES = ("_ids", "_slots", "_src", "_rows", "_idx")
ID_FIELD_EXTRAS = frozenset({"bkt_head"})

LintHit = Tuple[str, int, str, str]     # (path, lineno, rule, message)


def _call_name(node: ast.AST) -> Optional[str]:
    """Trailing name of a call target: ``a.b.c`` -> ``c``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_cache_name(name: str) -> bool:
    up = name.upper()
    return "CACHE" in up or "MEMO" in up


def is_id_field(name: str) -> bool:
    return name.endswith(ID_FIELD_SUFFIXES) or name in ID_FIELD_EXTRAS


# ---------------------------------------------------------------------------
# DispatchPlan structural rules (core/plan.py)
# ---------------------------------------------------------------------------

def _find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def plan_fields(plan_tree: ast.Module) -> List[str]:
    """DispatchPlan field names, in declaration order, from the AST."""
    cls = _find_class(plan_tree, "DispatchPlan")
    if cls is None:
        return []
    return [stmt.target.id for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)]


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for stmt in cls.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
            return stmt
    return None


def _call_keywords(scope: ast.AST, callee_names) -> set:
    """All keyword names of calls to any of ``callee_names`` in scope."""
    out = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and _call_name(node.func) in callee_names:
            out.update(kw.arg for kw in node.keywords if kw.arg)
    return out


def _dict_keys_in(scope: ast.AST) -> set:
    """String keys of dict literals, ``dict(...)`` calls and subscript
    stores within ``scope``: how the layout helpers emit their fields."""
    out = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Dict):
            out.update(k.value for k in node.keys
                       if isinstance(k, ast.Constant) and isinstance(k.value, str))
        elif isinstance(node, ast.Call) and _call_name(node.func) == "dict":
            out.update(kw.arg for kw in node.keywords if kw.arg)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    out.add(t.slice.value)
    return out


def _module_tuples(tree: ast.Module) -> dict:
    """Module-level ``NAME = (...)`` assignments: name -> the element nodes."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, (ast.Tuple, ast.List)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.elts
    return out


def _tuple_strings(name: str, tuples: dict, seen=()) -> set:
    """The string constants of module tuple ``name``, through ``*OTHER``."""
    out = set()
    for e in tuples.get(name, ()):
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            out.add(e.value)
        elif isinstance(e, ast.Starred) and isinstance(e.value, ast.Name) \
                and e.value.id not in seen:
            out |= _tuple_strings(e.value.id, tuples, (*seen, name))
    return out


def _widen_covered(plan_tree: ast.Module, widen: ast.FunctionDef) -> set:
    covered = _call_keywords(widen, {"_replace"})
    tuples = _module_tuples(plan_tree)
    for node in ast.walk(widen):
        if isinstance(node, ast.Name) and node.id in tuples:
            covered |= _tuple_strings(node.id, tuples)
    return covered


def _lint_plan_coverage(pkg_root: Path) -> List[LintHit]:
    hits: List[LintHit] = []
    plan_path = pkg_root / "core" / "plan.py"
    plan_tree = ast.parse(plan_path.read_text())
    fields = plan_fields(plan_tree)
    if not fields:
        return [(str(plan_path), 1, "plan-widen-coverage", "DispatchPlan class not found")]
    cls = _find_class(plan_tree, "DispatchPlan")

    widen = _method(cls, "widen")
    covered = _widen_covered(plan_tree, widen) if widen else set()
    for f in fields:
        if is_id_field(f) and f not in covered:
            hits.append((str(plan_path), cls.lineno, "plan-widen-coverage",
                         f"id field {f!r} missing from widen()'s _replace — it would reach "
                         f"kernels as int16"))

    build_kw = _call_keywords(plan_tree, {"DispatchPlan"}) | _dict_keys_in(plan_tree)
    shard_path = pkg_root / "distributed" / "plan_shard.py"
    if shard_path.exists():
        build_kw |= _dict_keys_in(ast.parse(shard_path.read_text()))
    for f in fields:
        if f not in build_kw:
            hits.append((str(plan_path), cls.lineno, "plan-rebuild-coverage",
                         f"DispatchPlan field {f!r} is never produced on the build/rebuild "
                         f"path"))

    dit_path = pkg_root / "models" / "dit.py"
    if dit_path.exists():
        specs_fn = next((node for node in ast.walk(ast.parse(dit_path.read_text()))
                         if isinstance(node, ast.FunctionDef)
                         and node.name == "engine_state_specs"), None)
        if specs_fn is None:
            return hits + [(str(dit_path), 1, "plan-spec-coverage",
                            "engine_state_specs not found")]
        spec_kw = _call_keywords(specs_fn, {"DispatchPlan", "_replace"})
        for f in fields:
            if f not in spec_kw:
                hits.append((str(dit_path), specs_fn.lineno, "plan-spec-coverage",
                             f"DispatchPlan field {f!r} has no entry in engine_state_specs"))
    return hits


# ---------------------------------------------------------------------------
# Generic repo rules (every module)
# ---------------------------------------------------------------------------

def _lint_module(path: str, tree: ast.Module) -> List[LintHit]:
    hits: List[LintHit] = []

    # module-dict-cache: module-level CACHE/MEMO dict literals
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        unbounded = isinstance(node.value, (ast.Dict, ast.DictComp)) or (
            isinstance(node.value, ast.Call) and _call_name(node.value.func) == "dict")
        if not unbounded:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and _is_cache_name(t.id):
                hits.append((path, node.lineno, "module-dict-cache",
                             f"{t.id} is an unbounded module-level dict — bound it "
                             f"(functools.lru_cache)"))

    # id-keyed-cache: a SIMPLE statement touching a CACHE/MEMO-named store
    # while keying (directly or through a local assigned from ``id(...)``) by
    # object identity.  Compound statements are skipped, and taint is per
    # enclosing scope, so a transient local dict keyed by ``id`` over pinned
    # objects stays legal as long as no cache is involved.
    simple = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Return, ast.Assert,
              ast.Raise, ast.Delete)

    def calls_id(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id == "id" for n in ast.walk(node))

    seen = set()
    scopes = [tree] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    for scope in scopes:
        tainted = {t.id for n in ast.walk(scope)
                   if isinstance(n, ast.Assign) and calls_id(n.value)
                   for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(scope):
            if not isinstance(node, simple) or node.lineno in seen:
                continue
            touches_cache = any(
                (isinstance(n, ast.Name) and _is_cache_name(n.id))
                or (isinstance(n, ast.Attribute) and _is_cache_name(n.attr))
                for n in ast.walk(node))
            if not touches_cache:
                continue
            if calls_id(node) or any(isinstance(n, ast.Name) and n.id in tainted
                                     for n in ast.walk(node)):
                seen.add(node.lineno)
                hits.append((path, node.lineno, "id-keyed-cache",
                             "cache access keyed by id(obj) — addresses recycle after gc; "
                             "key by VALUE (strategy_key / frozen config)"))
    return hits


def lint_source(source: str, path: str = "<memory>") -> List[LintHit]:
    """Lint one in-memory module (generic rules only)."""
    return _lint_module(path, ast.parse(source))


def lint_sources(src_root) -> List[LintHit]:
    """Lint the port under ``src_root`` (the directory that holds
    ``repro_torch``): plan coverage + the generic rules."""
    pkg_root = Path(src_root) / "repro_torch"
    hits = _lint_plan_coverage(pkg_root)
    for path in sorted(pkg_root.rglob("*.py")):
        hits.extend(_lint_module(str(path), ast.parse(path.read_text())))
    return hits
