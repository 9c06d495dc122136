"""vali_tpu_torch against vali_tpu: package boundary, enums, format
tables, colour matrices, resampling matrices and the kernels' band
tables."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vali_tpu
import vali_tpu_torch
from vali_tpu.core import enums as jenums
from vali_tpu.core import formats as jformats
from vali_tpu.ops import colors as jcolors
from vali_tpu.ops import fused as jfused
from vali_tpu.ops import pallas_fused as jpallas
from vali_tpu.ops import resize as jresize
from vali_tpu_torch.core import enums as tenums
from vali_tpu_torch.core import formats as tformats
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops import colors as tcolors
from vali_tpu_torch.ops import fused as tfused
from vali_tpu_torch.ops import resize as tresize

SIZES = [(1080, 224), (1920, 224), (540, 224), (960, 224), (64, 64),
         (62, 30), (130, 34), (36, 100), (100, 36), (720, 90), (1280, 160)]


def test_import_without_jax():
    """The port imports with JAX and vali_tpu blocked: every module of
    the package, found by walking it, the bench's among them, and none
    pulls in the root bench.py or bench_configs.py."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vali_tpu'] = None\n"
        "import vali_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    vali_tpu_torch.__path__, 'vali_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        "print(vali_tpu_torch.PySurfaceRotator.__name__)\n"
        "print(vali_tpu_torch.Surface.__name__)\n"
        "assert {'vali_tpu_torch.bench', 'vali_tpu_torch.bench_configs',\n"
        "        'vali_tpu_torch.lab.timing',\n"
        "        'vali_tpu_torch.samples.sample_transcode'} <= set(names)\n"
        "assert 'bench' not in sys.modules\n"
        "assert 'bench_configs' not in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'vali_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(vali_tpu_torch.PixelFormat.NV12.name)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    count, *rest = res.stdout.split()
    assert int(count) > 60
    assert rest == ["PySurfaceRotator", "Surface", "NV12"]


def test_no_module_imports_jax_or_the_jax_package():
    """No import statement of the port's modules or of chip_smoke.py, at
    the top or inside a function, names JAX or vali_tpu."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "vali_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, root)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in ("jax", "vali_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("library", ["product", "lab"])
def test_launcher_signatures_match_the_c_prototypes(library):
    """Every launcher's ctypes argtypes follow its C prototype, in each of
    the two kernel libraries (the product's, the labs'): a pointer or the
    stream as c_void_p (or a float pointer), long long as c_longlong, int
    as c_int. A missing or short list would let ctypes cut a pointer to 32
    bits. Each library builds its own sources, so a product wrapper's
    first launch compiles no lab kernel."""
    import ctypes
    import re

    from vali_tpu_torch.ops import _cuda_build as cb

    sources, signatures = {
        "product": (cb._SOURCES, cb._SIGNATURES),
        "lab": (cb._LAB_SOURCES, cb._LAB_SIGNATURES)}[library]
    assert "csrc/cuda_errors.cu" in sources   # banded_error_string
    text = "".join(open(os.path.join(cb._PKG_DIR, rel)).read()
                   for rel in sources)
    names = re.findall(r"^int (\w+_launch)\(", text, re.M)
    assert sorted(names) == sorted(signatures)
    for name, argtypes in signatures.items():
        params = re.search(r"int %s\(([^)]*)\)" % name, text).group(1)
        want = []
        for p in (p.strip() for p in params.split(",")):
            if "*" in p:
                want.append("ptr")
            elif p.startswith("long long"):
                want.append("ll")
            else:
                assert p.startswith("int "), p
                want.append("int")
        got = ["ll" if t is ctypes.c_longlong else
               "int" if t is ctypes.c_int else "ptr" for t in argtypes]
        assert got == want, name


def test_enums_and_exports_match():
    for name in ("PixelFormat", "ColorSpace", "ColorRange", "TaskExecInfo",
                 "TaskExecStatus", "DecodeMode", "SeekMode",
                 "FfmpegLogLevel", "DLDeviceType", "NV_ENC_CAPS"):
        a, b = getattr(jenums, name), getattr(tenums, name)
        assert [(m.name, int(m)) for m in a] == \
            [(m.name, int(m)) for m in b], name
    assert tenums.NO_PTS == jenums.NO_PTS
    assert int(vali_tpu_torch.NV12) == int(vali_tpu.NV12)


def test_format_plane_dims_match():
    for fmt in jformats.all_formats():
        ji = jformats.format_info(fmt)
        ti = tformats.format_info(tenums.PixelFormat(int(fmt)))
        assert ji.dtype == ti.dtype and ji.bit_depth == ti.bit_depth
        for w, h in ((1920, 1080), (256, 144), (64, 48)):
            assert ji.plane_dims(w, h) == ti.plane_dims(w, h)
            assert ji.host_size(w, h) == ti.host_size(w, h)


def test_color_matrices_match():
    for space in jenums.ColorSpace:
        for rng in jenums.ColorRange:
            a = jcolors.yuv2rgb_matrix(space, rng)
            b = tcolors.yuv2rgb_matrix(tenums.ColorSpace(int(space)),
                                       tenums.ColorRange(int(rng)))
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a[0], b[0]) and a[1] == b[1]
            a = jcolors.rgb2yuv_matrix(space, rng)
            b = tcolors.rgb2yuv_matrix(tenums.ColorSpace(int(space)),
                                       tenums.ColorRange(int(rng)))
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a[0], b[0]) and a[1] == b[1]


@pytest.mark.parametrize("method", tresize.METHODS)
def test_resampling_matrices_match(method):
    for n_in, n_out in SIZES:
        assert np.array_equal(jresize.resize_weights(n_in, n_out, method),
                              tresize.resize_weights(n_in, n_out, method))
        # chroma: half-resolution axis onto the destination grid
        assert np.array_equal(
            jfused._chroma_weights(n_in // 2, n_out, n_in, method),
            tfused._chroma_weights(n_in // 2, n_out, n_in, method))


def _expand(start, count, weights, n_in):
    dense = np.zeros((len(start), n_in), np.float32)
    for o, (s, c) in enumerate(zip(start, count)):
        dense[o, s:s + c] = weights[o, :c]
    return dense


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("method", tresize.METHODS)
def test_band_table_expands_to_dense(method, cdt):
    for n_in, n_out in SIZES:
        dense_sets = [tresize.resize_weights(n_in, n_out, method)]
        if n_in % 2 == 0:
            dense_sets.append(
                tfused._chroma_weights(n_in // 2, n_out, n_in, method))
        for dense in dense_sets:
            start, count, w = banded.band_table(dense, cdt)
            m = dense.shape[1]
            assert start.dtype == count.dtype == np.int32
            assert (start >= 0).all() and (start + count <= m).all()
            assert (count >= 1).all()
            assert w.shape == (n_out, count.max())
            want = banded.round_to(dense, cdt).numpy()
            assert np.array_equal(_expand(start, count, w, m), want)


def test_compute_dtype_policy_matches():
    import jax.numpy as jnp

    for hbd in (False, True):
        assert banded.resolve_compute_dtype(None, hbd) == (
            torch.float32 if hbd else torch.bfloat16)
        assert np.dtype(jpallas._resolve_compute_dtype(None, hbd)) == (
            np.dtype(np.float32) if hbd else np.dtype(jnp.bfloat16))
        assert banded.resolve_compute_dtype(torch.float32, hbd) == \
            torch.float32
    for jbad, tbad, hbd in ((jnp.float16, torch.float16, False),
                            (jnp.bfloat16, torch.bfloat16, True)):
        with pytest.raises(ValueError) as je:
            jpallas._resolve_compute_dtype(jbad, hbd)
        with pytest.raises(ValueError) as te:
            banded.resolve_compute_dtype(tbad, hbd)
        assert str(je.value).split(",")[0].split(" got")[0] == \
            str(te.value).split(",")[0].split(" got")[0]


def test_kernel_formats_cover_the_decoded_path():
    fmts = banded.kernel_preprocess_formats()
    assert {int(f) for f in fmts} == {
        int(f) for f in jpallas.pallas_preprocess_formats()}
    assert tenums.PixelFormat.YUV420 in fmts
    assert tenums.PixelFormat.NV12 in fmts
    assert tenums.PixelFormat.YUV444_10bit not in fmts


def test_host_frame_layout_matches():
    from vali_tpu.memory import host as jhost
    from vali_tpu_torch.memory import host as thost

    rng = np.random.default_rng(4)
    for fmt in (jenums.PixelFormat.NV12, jenums.PixelFormat.P10,
                jenums.PixelFormat.YUV420, jenums.PixelFormat.YUV420_10bit,
                jenums.PixelFormat.YUV422, jenums.PixelFormat.YUV444):
        size = jformats.format_info(fmt).host_size(64, 48)
        frame = rng.integers(0, 256, size, dtype=np.uint8)
        a = jhost.host_frame_to_planes(frame, fmt, 64, 48)
        b = thost.host_frame_to_planes(frame, tenums.PixelFormat(int(fmt)),
                                       64, 48)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(thost.planes_to_host_frame(b), frame)
