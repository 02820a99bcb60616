"""The port's examples (examples_torch/) against the JAX package's (examples/).

Each counterpart runs on the CPU, and its stdout is held line by line
against its JAX twin's under the rules of tests/examples_parity.py.
"""

import ast
import importlib.util
import os

import pytest
from examples_parity import EXAMPLES, JAX_RENAMES, compare, main_kwargs

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
JAX_DIR = os.path.join(ROOT, "examples")
PORT_DIR = os.path.join(ROOT, "examples_torch")


def load(directory, name, renames=()):
    path = os.path.join(directory, f"{name}.py")
    src = open(path).read()
    for old, new in renames:
        assert old in src, f"{name}: {old!r} is not in the example"
        src = src.replace(old, new)
    spec = importlib.util.spec_from_loader(
        f"gvdb_{os.path.basename(directory)}_{name}", loader=None, origin=path)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def run(mod, where, monkeypatch, device=None):
    os.makedirs(where, exist_ok=True)
    monkeypatch.chdir(where)  # examples that write relative dirs stay in tmp
    return mod.main(**main_kwargs(mod.main, where, device))


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_example_runs(name, tmp_path, monkeypatch):
    out = run(load(PORT_DIR, name), str(tmp_path), monkeypatch, device="cpu")
    assert isinstance(out, dict) and out, out


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_example_prints_what_the_jax_example_prints(name, tmp_path, monkeypatch, capsys):
    capsys.readouterr()
    run(load(JAX_DIR, name, JAX_RENAMES.get(name, ())), str(tmp_path / "jax"), monkeypatch)
    jax_out = capsys.readouterr().out
    run(load(PORT_DIR, name), str(tmp_path / "port"), monkeypatch, device="cpu")
    port_out = capsys.readouterr().out
    assert port_out.strip()
    compare(name, jax_out, port_out)


def imported_modules(tree):
    """Every module a file imports: import statements, and __import__ /
    importlib.import_module calls on a string."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fname = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if fname in ("__import__", "import_module"):
                yield str(node.args[0].value)


def test_every_example_has_a_counterpart_that_imports_no_jax():
    jax_names = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".py"))
    port_names = sorted(f for f in os.listdir(PORT_DIR) if f.endswith(".py"))
    assert jax_names == port_names
    assert sorted(f"{n}.py" for n in EXAMPLES) == port_names
    for fname in port_names:
        tree = ast.parse(open(os.path.join(PORT_DIR, fname)).read())
        roots = {m.split(".")[0] for m in imported_modules(tree)}
        assert not roots & {"jax", "jaxlib", "grape_vector_db_tpu"}, (fname, roots)
        assert "grape_vector_db_tpu_torch" in roots, fname


def test_no_counterpart_text_names_the_tpu():
    for fname in sorted(os.listdir(PORT_DIR)):
        if fname.endswith(".py"):
            text = open(os.path.join(PORT_DIR, fname)).read()
            for word in ("v5e", "TPU"):
                assert word not in text, (fname, word)
