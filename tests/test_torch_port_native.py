"""vali_tpu_torch's own native engine (engine/_native_build.py and
engine/_loader.py): built from the repository's C++ engine into
build/vali_tpu_torch/native/, never read from the JAX package's
extension, distinct from it in one process, decoding as it does, built
once when processes race, and from the sources and flags setup.py
names."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import vali_tpu
import vali_tpu_torch
from vali_tpu_torch.engine import _loader, _native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.dirname(os.path.abspath(vali_tpu.__file__))


def _python(code, *args, timeout=240):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def _under(path, directory):
    path = os.path.realpath(path)
    return os.path.commonpath([path, directory]) == directory


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from vali_tpu_torch.utils.synth import synthesize_clip

    return synthesize_clip(str(tmp_path_factory.mktemp("native") / "c.mp4"),
                           128, 96, n=8, chroma="sweep")


#: records every path the process opens, lists or stats, then loads the
#: port's engine and decodes a clip through it
_AUDIT = """
import json, os, sys
seen = []
def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir", "ctypes.dlopen") \\
            and args and isinstance(args[0], (str, bytes, os.PathLike)):
        seen.append(os.fsdecode(args[0]))
sys.addaudithook(hook)
_stat = os.stat
def stat(path, *a, **k):
    if isinstance(path, (str, bytes, os.PathLike)):
        seen.append(os.fsdecode(path))
    return _stat(path, *a, **k)
os.stat = stat
import numpy as np
import vali_tpu_torch as vali
from vali_tpu_torch.engine._loader import load_native
dec = vali.PyDecoder(sys.argv[1], {}, gpu_id=-1)
frame = np.zeros(dec.HostFrameSize, np.uint8)
n = 0
while dec.DecodeSingleFrame(frame)[0]:
    n += 1
print(json.dumps({"seen": seen, "file": load_native().__file__,
                  "frames": n, "modules": sorted(
                      k for k in sys.modules
                      if k == "vali_tpu" or k.startswith("vali_tpu."))}))
"""


def test_loader_never_opens_a_path_of_the_jax_package(clip):
    res = _python(_AUDIT, clip)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["frames"] == 8
    assert got["modules"] == []
    assert _under(got["file"], os.path.realpath(_native_build.BUILD_DIR))
    assert got["seen"], "the audit saw no path at all"
    opened = [p for p in got["seen"]
              if _under(p, os.path.realpath(JAX_PKG))
              or os.path.basename(p) == "setup.py"]
    assert not opened, opened


def test_the_loaded_module_is_the_ports_own_file():
    mod = _loader.load_native()
    assert mod.__name__ == _loader.MODULE == "vali_tpu_torch._native"
    assert sys.modules[_loader.MODULE] is mod
    assert _under(mod.__file__, os.path.realpath(_native_build.BUILD_DIR))
    assert os.path.basename(mod.__file__).startswith("_native-")


_BOTH = """
import json, sys
from vali_tpu.engine._loader import load_native as jax_engine
ref = jax_engine()
assert sys.modules["vali_tpu._native"] is ref
from vali_tpu_torch.engine._loader import load_native
port = load_native()
print(json.dumps({"distinct": port is not ref,
                  "files": [ref.__file__, port.__file__],
                  "names": [ref.__name__, port.__name__],
                  "ref_kept": sys.modules["vali_tpu._native"] is ref}))
"""


def test_port_loads_its_own_module_after_the_jax_package_loaded_its():
    res = _python(_BOTH)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["distinct"] and got["ref_kept"]
    ref_file, port_file = (os.path.realpath(f) for f in got["files"])
    assert ref_file != port_file
    assert _under(ref_file, os.path.realpath(JAX_PKG))
    assert _under(port_file, os.path.realpath(_native_build.BUILD_DIR))
    assert got["names"] == ["vali_tpu._native", "vali_tpu_torch._native"]


def test_both_engines_decode_bit_equal_planes_in_one_process(clip):
    frames = []
    for pkg in (vali_tpu, vali_tpu_torch):
        dec = pkg.PyDecoder(clip, {}, gpu_id=-1)
        buf = np.zeros(dec.HostFrameSize, np.uint8)
        out = []
        while dec.DecodeSingleFrame(buf)[0]:
            out.append(buf.copy())
        frames.append(out)
    assert len(frames[0]) == len(frames[1]) == 8
    for a, b in zip(*frames):
        assert np.array_equal(a, b)
    import vali_tpu.engine._loader as jax_loader

    assert jax_loader.load_native() is not _loader.load_native()


#: loads the engine built into argv[1], logging the pid of every
#: compiler run it starts to argv[2]
_BUILD_INTO = """
import os, sys
from vali_tpu_torch.engine import _native_build
from vali_tpu_torch.utils import _build
_native_build.BUILD_DIR = sys.argv[1]
run = _build.run_all
def logged(cmds):
    with open(sys.argv[2], "a") as f:
        f.write(f"{os.getpid()}\\n")
    return run(cmds)
_build.run_all = logged
from vali_tpu_torch.engine._loader import load_native
print(load_native().__file__)
"""


def test_racing_first_builds_both_load_one_library(tmp_path):
    build = str(tmp_path / "native")
    runs = tmp_path / "runs.log"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_INTO, build,
                               str(runs)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-2000:]
        outs.append(out.strip().splitlines()[-1])
    libs = [n for n in os.listdir(build) if n.endswith(".so")]
    assert len(libs) == 1
    assert outs[0] == outs[1] == os.path.join(build, libs[0])
    assert sorted(os.listdir(build)) == sorted(libs + ["lock"])
    # one process compiled (its compile and link runs); the other waited
    # on the lock and loaded that library
    assert len(set(runs.read_text().split())) == 1


def _setup_extension_keyword(name):
    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "Extension"]
    assert len(calls) == 1
    (kw,) = [k for k in calls[0].keywords if k.arg == name]
    return ast.literal_eval(kw.value)


@pytest.mark.parametrize("keyword, ours", [
    ("sources", _native_build.SOURCES),
    ("extra_compile_args", _native_build.FLAGS),
])
def test_the_build_matches_setup_py(keyword, ours):
    assert list(ours) == list(_setup_extension_keyword(keyword))


def test_setup_py_reads_the_same_packages_and_switch():
    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    assigned = {t.id: n.value for n in tree.body if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert tuple(ast.literal_eval(assigned["FFMPEG_PKGS"])) == \
        _native_build.FFMPEG_PKGS
    assert ast.literal_eval(assigned["libraries"]) == ["jpeg"]
    text = ast.unparse(assigned["DIRECT_LINK"])
    assert "VALI_DIRECT_LINK" in text
    assert "('1', 'true', 'yes', 'on')" in text


@pytest.mark.parametrize("value, on", [
    ("1", True), ("true", True), (" Yes ", True), ("ON", True),
    ("0", False), ("", False), ("no", False),
])
def test_direct_link_switch_reads_as_setup_py(monkeypatch, value, on):
    monkeypatch.setenv("VALI_DIRECT_LINK", value)
    assert _native_build.direct_link() is on
    cflags, ldflags = _native_build.flags()
    assert ("-DVALI_DIRECT_LINK=1" in cflags) is on
    assert any(f.startswith("-lav") for f in ldflags) is on
    assert ldflags[0] == "-ljpeg"


def test_the_key_follows_the_headers(monkeypatch, tmp_path):
    src = tmp_path / "native"
    shutil.copytree(_native_build.NATIVE_DIR, src)
    monkeypatch.setattr(_native_build, "NATIVE_DIR", str(src))
    cflags, ldflags = ["-O2"], ["-ljpeg"]
    key = _native_build._key(cflags, ldflags)
    assert _native_build._key(cflags, ldflags) == key
    assert _native_build._key(cflags + ["-DX"], ldflags) != key
    with open(src / "common.hpp", "a") as f:
        f.write("\n// touched\n")
    assert _native_build._key(cflags, ldflags) != key


def test_a_failed_build_raises_import_error_once_and_is_remembered(
        monkeypatch):
    calls = []

    def fail():
        calls.append(1)
        raise RuntimeError("pkg-config --cflags libavformat failed: none\n"
                           "last line of the output")

    monkeypatch.setattr(_loader, "_native", None)
    monkeypatch.setattr(_loader, "_error", None)
    monkeypatch.setattr(_native_build, "build", fail)
    with pytest.raises(ImportError, match="Failed to build the native "
                       "engine: pkg-config") as first:
        _loader.load_native()
    assert "last line of the output" in str(first.value)
    with pytest.raises(ImportError, match="native engine unavailable"):
        _loader.load_native()
    assert len(calls) == 1


def test_missing_pkg_config_is_a_build_error(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("pkg-config")

    monkeypatch.setattr(_native_build.subprocess, "check_output", missing)
    with pytest.raises(RuntimeError, match="pkg-config not found"):
        _native_build.flags()
