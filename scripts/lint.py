"""Stdlib AST linter (no ruff/flake8 in the baked image).

Mirrors the intent of the reference's `cargo clippy -D warnings` CI gate
(/root/reference/.github/workflows/ci.yml:28-29): a fast, zero-dependency
pass that fails the build on the defect classes that actually bite this
codebase:

  F401  unused import
  F811  redefinition of an imported name by a later import
  E722  bare `except:`
  B006  mutable default argument
  B008  function call in default argument (jnp/np array defaults trace once)
  W291  trailing whitespace
  W605  invalid escape sequence in a non-raw string literal
  T100  tab indentation

Usage: python scripts/lint.py [paths...]   (default: fugue_tpu tests
scripts bench.py serve-less root modules)
"""
from __future__ import annotations

import ast
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PATHS = ["fugue_tpu", "tests", "scripts", "examples",
                 "bench.py", "chip_smoke.py", "__graft_entry__.py"]
ALLOWED_CALL_DEFAULTS = {
    # frozen/hashable config factories are the documented idiom
    "HMCConfig", "NUTSConfig", "ChEESConfig", "SMCConfig", "VIConfig",
    "ABCConfig", "ABCSMCConfig", "PTConfig", "ESSConfig", "MHConfig",
    "GibbsConfig", "MAPConfig", "field", "PRNGKey",
    "ConjugateNormalConfig", "ConjugateBetaBernoulliConfig",
}


def iter_py(paths):
    for p in paths:
        full = os.path.join(REPO, p)
        if os.path.isfile(full):
            yield full
        else:
            for root, dirs, files in os.walk(full):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


class ImportChecker(ast.NodeVisitor):
    def __init__(self):
        self.imported: dict = {}  # name -> (lineno, node kind)
        self.used: set = set()

    def visit_Import(self, node):
        for a in node.names:
            if a.asname is None and "." in a.name:
                continue  # `import a.b.c` — namespace/side-effect import
            name = (a.asname or a.name).split(".")[0]
            self.imported.setdefault(name, node.lineno)

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imported.setdefault(a.asname or a.name, node.lineno)

    def visit_Name(self, node):
        self.used.add(node.id)

    def visit_Attribute(self, node):
        self.generic_visit(node)


def check_file(path) -> list:
    problems = []
    rel = os.path.relpath(path, REPO)
    with open(path, "r") as f:
        src = f.read()
    try:
        tree = ast.parse(src, path)
    except SyntaxError as e:
        return [(rel, e.lineno or 0, "E999", f"syntax error: {e.msg}")]

    lines = src.splitlines()
    for i, text in enumerate(lines, 1):
        if text.rstrip() != text and text.strip():
            problems.append((rel, i, "W291", "trailing whitespace"))
        if text.startswith("\t"):
            problems.append((rel, i, "T100", "tab indentation"))

    noqa = {i for i, text in enumerate(lines, 1) if "# noqa" in text}

    ic = ImportChecker()
    ic.visit(tree)
    # names referenced anywhere (incl. strings in __all__)
    all_names = set(ic.used)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            all_names.add(node.value)
    # __init__.py imports are the re-export surface (lib.rs:16-59 analog)
    if os.path.basename(path) != "__init__.py":
        for name, lineno in ic.imported.items():
            if name not in all_names and not name.startswith("_"):
                problems.append(
                    (rel, lineno, "F401", f"unused import {name!r}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            problems.append((rel, node.lineno, "E722", "bare except"))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.args.defaults + node.args.kw_defaults:
                if d is None:
                    continue
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        (rel, d.lineno, "B006", "mutable default argument"))
                elif isinstance(d, ast.Call):
                    fn = d.func
                    name = (fn.id if isinstance(fn, ast.Name)
                            else fn.attr if isinstance(fn, ast.Attribute)
                            else "")
                    if name not in ALLOWED_CALL_DEFAULTS:
                        problems.append(
                            (rel, d.lineno, "B008",
                             f"call in default argument ({name})"))
    return [p for p in problems if p[1] not in noqa]


def main():
    paths = sys.argv[1:] or DEFAULT_PATHS
    all_problems = []
    n_files = 0
    for path in iter_py(paths):
        n_files += 1
        all_problems.extend(check_file(path))
    for rel, line, code, msg in sorted(all_problems):
        print(f"{rel}:{line}: {code} {msg}")
    print(f"lint: {n_files} files, {len(all_problems)} problems")
    sys.exit(1 if all_problems else 0)


if __name__ == "__main__":
    main()
