"""Nothing under port_bench/ imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""
import ast

import pytest

from port_bench.lib import guard, spec

SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(spec.ROOT).as_posix())
def test_no_jax(path):
    assert not guard.forbidden_in(imports(path)), path


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.relative_to(spec.ROOT).as_posix())
def test_reference_imports_nothing_of_the_port(path):
    banned = guard.FORBIDDEN | {"md_rdm_tpu_torch", "port_bench"}
    assert not guard.forbidden_in(imports(path), banned), path


def test_names_are_compared_whole():
    assert guard.forbidden_in(["md_rdm_tpu_torch.inference",
                               "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_in(["jax.numpy", "md_rdm_tpu.models"]) == [
        "jax", "md_rdm_tpu"]


def test_a_run_refuses_a_loaded_jax(monkeypatch, capsys):
    """run.py exits 4 with no result when JAX is in sys.modules."""
    import sys
    import types
    from port_bench import run
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "live.serve_b16", "--seed", "1",
                     "--seconds", "1"]) == 4
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
