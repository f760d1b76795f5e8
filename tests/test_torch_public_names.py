"""PyTorch port: the packages' public names. Each JAX ``__init__`` that has
a counterpart in the port exports the same names there, but for those in
:data:`NOT_PORTED` (each with its reason); the port exports no name the JAX
package lacks, but for those in :data:`PORT_ONLY`. The names are read from
the ``__init__`` sources (``from ... import`` and assignments), so no JAX
module is imported; ``tests/test_torch_imports.py`` imports the port's with
JAX, Pillow and OpenCV blocked."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX package (relative to twinvoice_tpu) → the port's (relative to
# twinvoice_tpu_torch): every one has its counterpart
PACKAGES = {
    "": "",
    "core": "core",
    "data": "data",
    "eval": "eval",
    "fusion": "fusion",
    "infer": "infer",
    "models": "models",
    "ocr": "ocr",
    "ocr.fonts": "ocr.fonts",
    "ocr.jaxocr": "ocr.torchocr",
    "ops": "ops",
    "parallel": "parallel",
    "port": "port",
    "qr": "qr",
    "train": "train",
    "utils": "utils",
    "app": "app",
    "store": "store",
}

# (JAX package, name) → why the port's counterpart does not export it
NOT_PORTED = {
    ("ocr.jaxocr", "JaxOcrEngine"): "its counterpart is TorchOcrEngine",
}

# (port package, name) → why the JAX counterpart has no such name
PORT_ONLY = {
    ("", "resolve_device"): "the device an entry point runs on",
    ("eval", "load_cases"): "cases written by save_cases, read back",
    ("eval", "save_cases"): "the case file load_cases reads",
    ("ocr.fonts", "glyph_strokes"): "the stroke data the CJK charset is built from",
    ("ocr.torchocr", "TorchOcrEngine"): "the counterpart of JaxOcrEngine",
}


def exported(package: str, rel: str):
    """The names a package's ``__init__`` binds: those it imports with
    ``from ... import``, assigns or defines, dunder names but ``__version__``
    left out."""
    path = os.path.join(ROOT, package, *rel.split(".") if rel else [], "__init__.py")
    names = set()
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("__") or n == "__version__"}


@pytest.mark.parametrize("jax_rel,port_rel", sorted(PACKAGES.items()))
def test_port_exports_the_jax_names(jax_rel, port_rel):
    want = exported("twinvoice_tpu", jax_rel)
    got = exported("twinvoice_tpu_torch", port_rel)
    missing = {n for n in want - got if (jax_rel, n) not in NOT_PORTED}
    extra = {n for n in got - want if (port_rel, n) not in PORT_ONLY}
    assert not missing, f"twinvoice_tpu_torch.{port_rel} lacks {sorted(missing)}"
    assert not extra, f"twinvoice_tpu_torch.{port_rel} adds {sorted(extra)}"
    # each name in the tables is one the packages really differ in
    assert {n for (p, n) in NOT_PORTED if p == jax_rel} <= want - got
    assert {n for (p, n) in PORT_ONLY if p == port_rel} <= got - want
    mod = importlib.import_module("twinvoice_tpu_torch" + (f".{port_rel}" if port_rel else ""))
    assert all(hasattr(mod, n) for n in got)


def test_every_jax_package_is_listed():
    base = os.path.join(ROOT, "twinvoice_tpu")
    found = {os.path.relpath(d, base).replace(os.sep, ".")
             for d, _, files in os.walk(base) if "__init__.py" in files}
    found = {"" if f == "." else f for f in found}
    # the Pallas kernels and the Streamlit component have no public names
    assert found - set(PACKAGES) == {"ops.pallas", "app.camera_component"}
    assert set(PACKAGES) <= found
