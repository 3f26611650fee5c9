"""Lint guards for godsp_tpu_torch, mirroring tests/test_lint.py.

The port must never import jax (nor godsp_tpu, whose __init__ imports
jax): checked by an AST scan of every module (and of the example twins
under examples/torch) and by importing the
package in a fresh interpreter.  Every __all__ name must resolve, and no
collection may hold an implicit string concatenation.
"""

import ast
import importlib
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import godsp_tpu_torch
from godsp_tpu_torch import default_device, set_default_device
from test_lint import _element_is_implicit_concat

PKG = pathlib.Path(godsp_tpu_torch.__file__).parent
REPO = PKG.parent
FILES = sorted(PKG.rglob("*.py")) + sorted((REPO / "examples" / "torch").glob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "tests" / "test_torch_cuda.py",
    REPO / "tools" / "probe_torch_fft_profile.py",
]


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "godsp_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, godsp_tpu_torch, godsp_tpu_torch.ops, godsp_tpu_torch.models, "
        "godsp_tpu_torch.parallel, godsp_tpu_torch.native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'godsp_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_native_source_lies_in_the_port():
    from godsp_tpu_torch import native

    assert native._SRC.is_file()
    assert PKG in native._SRC.resolve().parents


def _jax_package_path_parts(tree: ast.AST) -> list[str]:
    """String constants that name the JAX package's directory as a path
    part: "godsp_tpu" itself, or a "godsp_tpu/..." path."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if v == "godsp_tpu" or (v.startswith("godsp_tpu/") and "\n" not in v
                                    and " " not in v):
                found.append(v)
    return found


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_the_jax_package(path):
    """No module of the port builds a path into godsp_tpu/ (it keeps its
    own copy of what it needs); prose in docstrings may name files there."""
    assert not _jax_package_path_parts(ast.parse(path.read_text())), path


def test_path_scan_catches_a_path_into_the_jax_package():
    src = '_SRC = _PKG.parent / "godsp_tpu" / "native" / "godsp_native.cpp"\n'
    assert _jax_package_path_parts(ast.parse(src)) == ["godsp_tpu"]
    assert _jax_package_path_parts(ast.parse('p = "godsp_tpu/native/x.cpp"\n'))


def test_no_implicit_str_concat_in_collections():
    offenders = []
    for path in FILES:
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
                for elt in node.elts:
                    if (
                        isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)
                        and _element_is_implicit_concat(src, elt)
                    ):
                        offenders.append(f"{path}:{elt.lineno}: {elt.value!r}")
    assert not offenders, "\n".join(offenders)


def test_all_exports_resolve():
    missing = []
    for info in pkgutil.walk_packages([str(PKG)], prefix="godsp_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name in getattr(mod, "__all__", ()):
            if not hasattr(mod, name):
                missing.append(f"{info.name}.{name}")
    assert not missing, missing


def test_no_shadowed_submodule():
    for info in pkgutil.walk_packages([str(PKG)], prefix="godsp_tpu_torch."):
        if not info.ispkg:
            continue
        pkg = importlib.import_module(info.name)
        for sub in pkgutil.iter_modules(pkg.__path__):
            attr = getattr(pkg, sub.name, None)
            if attr is not None:
                assert attr is importlib.import_module(f"{info.name}.{sub.name}"), (
                    f"{info.name}.{sub.name} is shadowed by a re-export"
                )
