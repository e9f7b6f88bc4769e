"""AST lint: the Model API invariants of the port, made machine-checkable.

A port of ``repro.analysis.repo_lint``: the same five rules, under the
same names, over ``src/repro_torch`` (reported as :class:`RepoFinding`;
``python -m repro_torch.analysis`` fails on any ERROR):

* **R1 no-deprecated-shims** — the port has none of the legacy
  ``Vampire.estimate_range`` / ``estimate_distribution`` /
  ``estimate_many`` / ``estimate_range_many`` /
  ``estimate_distribution_many`` shims: no file defines, calls or reads
  one (this linter is the one file allowed to name them); everything goes
  through ``estimate(traces, vendors, mode=..., impl=...)``.
* **R2 impls-declare-modes** — every ``register_impl(EstimateImpl(...))``
  passes an explicit ``modes=`` tuple.
* **R3 call-time-interpret**, in its torch meaning — a kernel wrapper
  chooses between its plain version and its kernel PER CALL, by where its
  tensors lie: inside ``kernels/`` no module-level ``*INTERPRET*`` flag is
  assigned; every module that loads a kernel library
  (``build.library(...)``) refers to ``on_cpu`` (the per-call choice) and
  checks its launches (``build.check``, or ``launch_charge``, which calls
  it); and no ``try`` around a library load or a launch has a handler that
  falls back to a plain version (on a card tensor a wrapper launches its
  kernel or raises).
* **R5 fitters-declare-streaming** — every
  ``register_fitter(FitterSpec(...))`` passes an explicit ``streaming=``.
* **R4 params-serialization-covered** — every ``PowerParams`` field is in
  the v2 field list (``model_api._FITTED_FIELDS``) or derived at load time
  (a keyword of ``PowerParams(...)`` in ``characterize.build_params``);
  and every serialized field added after the legacy v1 schema has a
  backfill default.  The port writes no v1 files, so the v1 key set is
  the constant :data:`V1_KEYS`, copied from the reference's
  ``_save_v1_pickle``.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable

ERROR = "error"
WARNING = "warning"

DEPRECATED_SHIMS = ("estimate_range", "estimate_distribution",
                    "estimate_many", "estimate_range_many",
                    "estimate_distribution_many")

#: the one file allowed to name the shims
_SHIM_DEF_FILES = ("analysis/repo_lint.py",)

#: the legacy schema-v1 blob keys: the keys of the dict literal in the
#: reference's ``repro.core.model_api._save_v1_pickle``
V1_KEYS = frozenset({"datadep", "i2n", "bank_open_delta", "bank_read_factor",
                     "bank_write_factor", "q_actpre", "row_ones_slope",
                     "q_ref", "i_pd", "idd_datasheet", "band"})


@dataclasses.dataclass(frozen=True)
class RepoFinding:
    rule: str       # 'no-deprecated-shims' | 'impls-declare-modes' |
                    # 'call-time-interpret' | 'params-serialization-covered'
                    # | 'fitters-declare-streaming'
    severity: str
    path: str       # relative to src/repro_torch
    line: int
    message: str

    def __str__(self):  # pragma: no cover - formatting
        return (f"[{self.severity.upper()}] {self.rule}: "
                f"{self.path}:{self.line} — {self.message}")


def errors_of(findings: Iterable[RepoFinding]) -> list[RepoFinding]:
    return [f for f in findings if f.severity == ERROR]


def _repo_src() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _iter_sources(root: pathlib.Path | None = None):
    root = root or _repo_src()
    for path in sorted(root.rglob("*.py")):
        yield path.relative_to(root).as_posix(), _parse(path)


# ---------------------------------------------------------------------------
# R1 — no deprecated shims
# ---------------------------------------------------------------------------
def check_no_deprecated_shims(sources=None) -> list[RepoFinding]:
    findings = []
    for rel, tree in (sources if sources is not None else _iter_sources()):
        if rel in _SHIM_DEF_FILES:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in DEPRECATED_SHIMS:
                findings.append(RepoFinding(
                    "no-deprecated-shims", ERROR, rel, node.lineno,
                    f"use of deprecated shim .{node.attr}; use "
                    f"estimate(..., mode=...)"))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in DEPRECATED_SHIMS:
                findings.append(RepoFinding(
                    "no-deprecated-shims", ERROR, rel, node.lineno,
                    f"definition of deprecated shim {node.name}(); the "
                    f"port has only the unified estimate()"))
    return findings


# ---------------------------------------------------------------------------
# R2 / R5 — registrations declare their capabilities
# ---------------------------------------------------------------------------
def _check_registrations(sources, register: str, spec: str, keyword: str,
                         rule: str) -> list[RepoFinding]:
    findings = []
    for rel, tree in (sources if sources is not None else _iter_sources()):
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == register and node.args):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)
                    and arg.func.id == spec):
                continue  # re-registration of an existing constant: fine
            if not any(kw.arg == keyword for kw in arg.keywords):
                findings.append(RepoFinding(
                    rule, ERROR, rel, node.lineno,
                    f"{register}({spec}(...)) without an explicit "
                    f"{keyword}= declaration"))
    return findings


def check_impls_declare_modes(sources=None) -> list[RepoFinding]:
    return _check_registrations(sources, "register_impl", "EstimateImpl",
                                "modes", "impls-declare-modes")


def check_fitters_declare_streaming(sources=None) -> list[RepoFinding]:
    return _check_registrations(sources, "register_fitter", "FitterSpec",
                                "streaming", "fitters-declare-streaming")


# ---------------------------------------------------------------------------
# R3 — kernels choose plain version or kernel per call
# ---------------------------------------------------------------------------
def _names(tree: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | \
           {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}


def _call_names(tree: ast.AST) -> set[str]:
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            f = n.func
            out.add(f.attr if isinstance(f, ast.Attribute)
                    else getattr(f, "id", ""))
    return out


def _loads_library(tree: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "library"
               and isinstance(n.func.value, ast.Name)
               and n.func.value.id == "build" for n in ast.walk(tree))


def _launches(tree: ast.AST) -> bool:
    calls = _call_names(tree)
    return (_loads_library(tree) or "launch_charge" in calls
            or any(c.startswith("repro_") for c in calls))


def check_call_time_interpret(sources=None) -> list[RepoFinding]:
    findings = []
    if sources is None:
        root = _repo_src() / "kernels"
        sources = [(f"kernels/{rel}", tree)
                   for rel, tree in _iter_sources(root)]
    for rel, tree in sources:
        # (a) no module-level *INTERPRET* flag assignment
        for node in tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and "INTERPRET" in t.id.upper():
                    findings.append(RepoFinding(
                        "call-time-interpret", ERROR, rel, node.lineno,
                        f"module-level flag {t.id!r}: a wrapper chooses "
                        f"between plain version and kernel per call "
                        f"(on_cpu)"))
        # (b) library users choose per call and check their launches
        if _loads_library(tree):
            names = _names(tree)
            if "on_cpu" not in names:
                findings.append(RepoFinding(
                    "call-time-interpret", ERROR, rel, 1,
                    "module loads a kernel library but never refers to "
                    "on_cpu (the per-call choice of plain version or "
                    "kernel)"))
            if "check" not in names and "launch_charge" not in names:
                findings.append(RepoFinding(
                    "call-time-interpret", ERROR, rel, 1,
                    "module loads a kernel library but never checks a "
                    "launch (build.check)"))
        # (c) no fallback from a failed load or launch to a plain version
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Try)
                    and any(_launches(s) for s in node.body)):
                continue
            for handler in node.handlers:
                if any("plain" in c for c in _call_names(handler)):
                    findings.append(RepoFinding(
                        "call-time-interpret", ERROR, rel, handler.lineno,
                        "a failed kernel load or launch falls back to the "
                        "plain version: on a card tensor a wrapper "
                        "launches its kernel or raises"))
    return findings


# ---------------------------------------------------------------------------
# R4 — PowerParams fields covered by the v2 serialization schema
# ---------------------------------------------------------------------------
def _class_fields(tree: ast.Module, cls: str) -> list[tuple[str, bool]]:
    """(field, has_default) per AnnAssign of the class, in order."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [(s.target.id, s.value is not None) for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
    raise ValueError(f"class {cls} not found")


def _tuple_literal(tree: ast.Module, name: str) -> list[str]:
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise ValueError(f"tuple literal {name} not found")


def _constructor_keywords(tree: ast.Module, func: str, cls: str) -> set[str]:
    """Keywords passed to ``cls(...)`` anywhere inside method/func
    ``func``."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == cls):
                    out |= {kw.arg for kw in sub.keywords if kw.arg}
    return out


def check_params_serialization(src_root: pathlib.Path | None = None,
                               v1_keys=V1_KEYS) -> list[RepoFinding]:
    root = src_root or _repo_src()
    em = _parse(root / "core" / "energy_model.py")
    ma = _parse(root / "core" / "model_api.py")
    ch = _parse(root / "core" / "characterize.py")

    fields = _class_fields(em, "PowerParams")
    fitted = set(_tuple_literal(ma, "_FITTED_FIELDS"))
    derived = _constructor_keywords(ch, "build_params", "PowerParams")

    findings = []
    for name, has_default in fields:
        if name not in fitted and name not in derived:
            findings.append(RepoFinding(
                "params-serialization-covered", ERROR,
                "core/energy_model.py", 1,
                f"PowerParams.{name} is neither serialized "
                f"(_FITTED_FIELDS) nor derived in characterize."
                f"build_params: save/load would drop it"))
        if name in fitted and name not in v1_keys and not has_default:
            findings.append(RepoFinding(
                "params-serialization-covered", ERROR,
                "core/energy_model.py", 1,
                f"PowerParams.{name} is serialized but post-v1 and has no "
                f"backfill default: legacy blobs would fail to load"))
    return findings


def run_repo_lint() -> list[RepoFinding]:
    """All five rules over the live ``src/repro_torch`` tree."""
    sources = list(_iter_sources())
    findings = []
    findings += check_no_deprecated_shims(sources)
    findings += check_impls_declare_modes(sources)
    findings += check_fitters_declare_streaming(sources)
    findings += check_call_time_interpret()
    findings += check_params_serialization()
    return findings
