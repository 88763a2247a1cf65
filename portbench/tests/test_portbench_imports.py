"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.

An AST walk from ``portbench/run.py`` over every module it reaches: the
benchmark's own (the entries and metrics it loads by name included) and
the program's (``repro_torch``, under ``src/``), every import statement
at any depth.  Names are compared as whole top-level names: ``repro_torch``
is the port, ``repro`` the JAX package."""
from __future__ import annotations

import ast
import os

import pytest

from portbench import run

ROOT = os.path.dirname(run.HERE)
SRC = os.path.join(ROOT, "src")
FORBIDDEN = set(run.FORBIDDEN)


def _imports(path):
    """(top-level name, dotted module) of every import in a file;
    relative imports resolved against the file's package."""
    tree = ast.parse(open(path).read(), path)
    rel = os.path.relpath(path, SRC if path.startswith(SRC) else ROOT)
    pkg = rel[:-3].replace(os.sep, ".").split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ".".join(pkg[:len(pkg) - node.level + 1] +
                                ([node.module] if node.module else []))
            else:
                base = node.module
            yield base.split(".")[0], base
            for a in node.names:
                yield base.split(".")[0], f"{base}.{a.name}"


def _file(module):
    for top in (ROOT, SRC):
        base = os.path.join(top, *module.split("."))
        for cand in (base + ".py", os.path.join(base, "__init__.py")):
            if os.path.exists(cand):
                return cand
    return None


def _reached():
    start = [os.path.join(run.HERE, "run.py")]
    for kind in ("entries", "metrics"):
        d = os.path.join(run.HERE, kind)
        start += [os.path.join(d, f) for f in sorted(os.listdir(d))
                  if f.endswith(".py")]
    seen, todo, found = set(), list(start), {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for top, module in _imports(path):
            found.setdefault(path, set()).add(top)
            if top in ("portbench", "repro_torch"):
                f = _file(module)
                if f:
                    todo.append(f)
    return found


def test_the_walk_reaches_the_program_and_the_reference():
    files = {os.path.relpath(p, ROOT) for p in _reached()}
    assert "portbench/reference/lm.py" in files
    assert "src/repro_torch/launch/train.py" in files
    assert "src/repro_torch/models/mla.py" in files


def test_nothing_reached_imports_jax_or_the_jax_package():
    bad = {os.path.relpath(p, ROOT): sorted(tops & FORBIDDEN)
           for p, tops in _reached().items() if tops & FORBIDDEN}
    assert bad == {}


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(run.HERE, "reference"))
    if f.endswith(".py")))
def test_the_reference_imports_nothing_of_the_program(name):
    tops = {t for t, m in _imports(os.path.join(run.HERE, "reference",
                                                name))}
    mods = {m for t, m in _imports(os.path.join(run.HERE, "reference",
                                                name))}
    assert not tops & ({"repro_torch"} | FORBIDDEN)
    assert not {m for m in mods if m.startswith("portbench.program")}
