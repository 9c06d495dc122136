"""pyproject.toml ships what vali_tpu_torch needs: every header its CUDA
sources include (a wheel builds the kernels from them at first use),
every sub-package, and the type stub with its py.typed marker."""

import fnmatch
import os
import re
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vali_tpu_torch")

with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
    SETUPTOOLS = tomllib.load(f)["tool"]["setuptools"]
PACKAGES = set(SETUPTOOLS["packages"])
DATA = SETUPTOOLS["package-data"]["vali_tpu_torch"]


def shipped(rel):
    return any(fnmatch.fnmatch(rel, pattern) for pattern in DATA)


def _includes():
    csrc = os.path.join(PKG, "csrc")
    out = set()
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name)) as f:
                out |= {(name, inc) for inc in
                        re.findall(r'^#include "([^"]+)"', f.read(), re.M)}
    return sorted(out)


def _subpackages():
    return sorted(
        os.path.relpath(d, REPO).replace(os.sep, ".")
        for d, _, files in os.walk(PKG)
        if "__init__.py" in files and "__pycache__" not in d)


def test_the_sources_include_local_headers():
    assert {inc for _, inc in _includes()} >= {"banded_common.cuh",
                                               "banded_preprocess.cuh"}


@pytest.mark.parametrize("source, header", _includes())
def test_every_included_header_ships(source, header):
    rel = os.path.join("csrc", header)
    assert os.path.isfile(os.path.join(PKG, rel)), (source, header)
    assert shipped(rel), (source, header, DATA)


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(PKG,
                                                                "csrc"))))
def test_every_kernel_source_ships(name):
    assert shipped(os.path.join("csrc", name))


@pytest.mark.parametrize("package", _subpackages())
def test_every_subpackage_is_listed(package):
    assert package in PACKAGES


def test_the_lab_and_the_samples_are_packages():
    assert {"vali_tpu_torch.lab", "vali_tpu_torch.samples"} <= PACKAGES


@pytest.mark.parametrize("name", ["__init__.pyi", "py.typed"])
def test_the_stub_ships(name):
    assert os.path.isfile(os.path.join(PKG, name))
    assert shipped(name)
