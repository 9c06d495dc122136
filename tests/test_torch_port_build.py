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


def test_kernel_libraries_build_apart_and_load_once(monkeypatch, tmp_path):
    """ops/_cuda_build.py builds the product's kernels and the labs' into
    two libraries under their own build directories (a product wrapper's
    first launch compiles no lab source), each once a process: a later
    load hashes no source, so a wrapper's call pays no file reads."""
    import types

    from vali_tpu_torch.ops import _cuda_build as cb

    built = []
    monkeypatch.setattr(cb, "_libs", {})
    monkeypatch.setattr(cb, "BUILD_DIR", str(tmp_path / "product"))
    monkeypatch.setattr(cb, "LAB_BUILD_DIR", str(tmp_path / "lab"))
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb, "locked_build",
                        lambda path, cmd, sources, link: built.append(
                            (path, [os.path.relpath(s, cb._PKG_DIR)
                                    for s in sources])) or path)

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: Lib())
    product, lab = cb.load_kernels(), cb.load_lab_kernels()
    assert product is not lab
    assert [p for p, _ in built] == [cb.library_path(),
                                     cb.lab_library_path()]
    assert built[0][0].startswith(str(tmp_path / "product"))
    assert built[1][0].startswith(str(tmp_path / "lab"))
    assert tuple(built[0][1]) == cb._SOURCES
    assert tuple(built[1][1]) == cb._LAB_SOURCES
    assert not set(cb._SOURCES) & set(cb._LAB_SOURCES) - {
        "csrc/cuda_errors.cu"}
    monkeypatch.setattr(cb, "source_key", None)   # a later hash would fail
    assert cb.load_kernels() is product and cb.load_lab_kernels() is lab
    assert len(built) == 2


def test_kernel_libraries_build_at_once(monkeypatch, tmp_path):
    """The product's and the labs' libraries build at the same time from
    two threads (chip_smoke.py starts both): each build waits, inside its
    lock, until the other has started."""
    import threading
    import types

    from vali_tpu_torch.ops import _cuda_build as cb

    started = {"product": threading.Event(), "lab": threading.Event()}
    overlapped = []

    def build(path, cmd, sources, link):
        which = "lab" if path.startswith(str(tmp_path / "lab")) else \
            "product"
        started[which].set()
        other = "product" if which == "lab" else "lab"
        overlapped.append(started[other].wait(5))
        return path

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cb, "_libs", {})
    monkeypatch.setattr(cb, "BUILD_DIR", str(tmp_path / "product"))
    monkeypatch.setattr(cb, "LAB_BUILD_DIR", str(tmp_path / "lab"))
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb, "locked_build", build)
    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: Lib())
    threads = [threading.Thread(target=f)
               for f in (cb.load_kernels, cb.load_lab_kernels)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert overlapped == [True, True]
