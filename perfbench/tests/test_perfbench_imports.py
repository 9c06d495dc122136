"""What the benchmark's modules import: no JAX and not the JAX package
(compared by whole top-level name: ``vali_tpu_torch`` begins with
``vali_tpu``), nothing of the program in the references, and none of the
port's own bench or labs anywhere."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(os.path.join(d, f), HERE)
               for d, _, fs in os.walk(HERE) for f in fs if f.endswith(".py"))


def imported(rel):
    with open(os.path.join(HERE, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_anywhere(rel):
    tops = {name.split(".")[0] for name in imported(rel)}
    assert not tops & {"jax", "jaxlib", "flax", "vali_tpu"}


@pytest.mark.parametrize("rel", FILES)
def test_not_the_ports_bench_or_labs(rel):
    for name in imported(rel):
        assert not name.startswith(("vali_tpu_torch.bench",
                                    "vali_tpu_torch.lab"))


@pytest.mark.parametrize("rel", [f for f in FILES
                                 if f.startswith("reference" + os.sep)])
def test_references_import_nothing_of_the_program(rel):
    assert all(name.split(".")[0] != "vali_tpu_torch"
               for name in imported(rel))


def test_the_scan_compares_whole_names():
    from perfbench.harness import forbidden_loaded
    import sys

    sys.modules["vali_tpu_torch_probe"] = sys
    try:
        assert "vali_tpu" not in forbidden_loaded()
    finally:
        del sys.modules["vali_tpu_torch_probe"]
