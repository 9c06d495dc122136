"""vali_tpu_torch/utils/_build.py, the build step the CUDA kernels and
the native engine share, driven here with the host's C++ compiler on a
one-function source: the key, a build, its reuse, and a failure."""

import ctypes
import os

import pytest

from vali_tpu_torch.engine._native_build import _compiler
from vali_tpu_torch.utils import _build

SOURCE = 'extern "C" int answer() { return 42; }\n'


@pytest.fixture
def src(tmp_path):
    path = tmp_path / "answer.cpp"
    path.write_text(SOURCE)
    return path


def _build_answer(src, out, calls=None):
    run = _build.run_all

    def counted(cmds):
        if calls is not None:
            calls.append(len(cmds))
        return run(cmds)

    cxx = _compiler()
    try:
        _build.run_all = counted
        return _build.locked_build(str(out), [*cxx, "-fPIC", "-O2"],
                                   [str(src)], [*cxx, "-shared"])
    finally:
        _build.run_all = run


def test_source_key_follows_the_words_and_the_bytes(src):
    root, names = str(src.parent), [src.name]
    key = _build.source_key(["c++", "-O2"], root, names)
    assert len(key) == 16
    assert _build.source_key(["c++", "-O2"], root, names) == key
    assert _build.source_key(["c++", "-O3"], root, names) != key
    src.write_text(SOURCE + "// touched\n")
    assert _build.source_key(["c++", "-O2"], root, names) != key


def test_locked_build_builds_once_and_leaves_only_the_library(src,
                                                              tmp_path):
    out = tmp_path / "lib" / "answer.so"
    calls = []
    assert _build_answer(src, out, calls) == str(out)
    assert calls == [1, 1]  # one compile run, one link
    assert ctypes.CDLL(str(out)).answer() == 42
    assert sorted(os.listdir(out.parent)) == ["answer.so", "lock"]
    assert _build_answer(src, out, calls) == str(out)
    assert calls == [1, 1]  # there already: nothing run


def test_a_failed_compile_names_the_tool_and_leaves_nothing(src, tmp_path):
    src.write_text("this is not C++\n")
    out = tmp_path / "lib" / "answer.so"
    with pytest.raises(RuntimeError) as err:
        _build_answer(src, out)
    first = str(err.value).splitlines()[0]
    assert first.startswith(f"{os.path.basename(_compiler()[0])} failed")
    assert str(src) in first
    assert os.listdir(out.parent) == ["lock"]
