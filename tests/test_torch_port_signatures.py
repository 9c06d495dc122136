"""vali_tpu_torch's public signatures against vali_tpu's: for every class
both packages export, and for each public method both classes define, a
positional call valid in the reference must mean the same in the port.
The port's positional parameters are a prefix of the reference's, in the
same order and under the same names (RENAMED maps the reference's
TPU-specific names to the port's), and its keyword-only parameters are
the reference's or listed in PORT_ONLY. A parameter the port lacks at the
end of the list is not a fault (ROADMAP lists it as missing)."""

import inspect

import numpy as np
import pytest

import vali_tpu as ref
import vali_tpu_torch as port
import torch

from vali_tpu.parallel import mesh as ref_mesh
from vali_tpu.pipeline import multistream as ref_ms
from vali_tpu_torch.parallel import mesh as port_mesh
from vali_tpu_torch.pipeline import multistream as port_ms

#: reference name -> the port's name for the same parameter in the same
#: place: the port's kernels are CUDA, not Pallas
RENAMED = {"use_pallas": "use_kernel"}
#: keyword-only parameters of the port's own, as (owner, parameter): a
#: Surface made from host memory on the CPU or a chosen card; the device
#: a decoder's Surface path writes to (the CPU for tests, where gpu_id
#: alone would ask for a card)
PORT_ONLY = {("Surface.from_cai", "gpu_id"), ("PyDecoder.__init__", "device")}
#: names both lazy maps hold, and the memory and event classes the
#: reference imports eagerly
_SHARED = sorted((set(ref._LAZY) & set(port._LAZY))
                 | {"Surface", "SurfacePlane", "CudaBuffer",
                    "CudaStreamEvent"})
#: the classes among them, and the module-level functions
NAMES = [n for n in _SHARED if inspect.isclass(getattr(ref, n))]
FUNCTIONS = [n for n in _SHARED if n not in NAMES]


def _classes(name):
    if name == "MultiStreamPipeline":
        return ref_ms.MultiStreamPipeline, port_ms.MultiStreamPipeline
    return getattr(ref, name), getattr(port, name)


def _params(fn):
    """(positional parameter names, keyword-only parameter names)."""
    ps = inspect.signature(fn).parameters.values()
    return ([p.name for p in ps if p.kind in (p.POSITIONAL_ONLY,
                                              p.POSITIONAL_OR_KEYWORD)],
            [p.name for p in ps if p.kind == p.KEYWORD_ONLY])


def _methods(a, b):
    """__init__ and the public methods both classes define."""
    shared = set(vars(a)) & set(vars(b))
    return ["__init__"] + sorted(
        m for m in shared if not m.startswith("_")
        and callable(getattr(a, m)) and callable(getattr(b, m)))


def _faults(owner, ref_fn, port_fn):
    r_pos, r_kw = _params(ref_fn)
    p_pos, p_kw = _params(port_fn)
    r_pos = [RENAMED.get(n, n) for n in r_pos]
    r_kw = {RENAMED.get(n, n) for n in r_kw}
    faults = []
    if p_pos != r_pos[:len(p_pos)]:
        faults.append(f"{owner}: positional {p_pos} is not a prefix of the "
                      f"reference's {r_pos}")
    extra = {n for n in p_kw if n not in r_kw} - {
        p for o, p in PORT_ONLY if o == owner}
    if extra:
        faults.append(f"{owner}: keyword-only {sorted(extra)} not in the "
                      f"reference")
    return faults


@pytest.mark.parametrize("name", NAMES + ["MultiStreamPipeline"])
def test_positional_parameters_keep_the_reference_order(name):
    a, b = _classes(name)
    faults = []
    for m in _methods(a, b):
        faults += _faults(f"{name}.{m}", getattr(a, m), getattr(b, m))
    assert not faults, "\n".join(faults)


def test_the_shared_names_hold_the_engine_functions():
    assert FUNCTIONS == ["GetNvencParams", "SetFFMpegLogLevel"]
    assert {"BufferedReader", "PyDecoder", "PyNvEncoder"} <= set(NAMES)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_functions_keep_the_reference_parameters(name):
    a, b = getattr(ref, name), getattr(port, name)
    assert callable(a) and callable(b)
    assert _params(b) == _params(a)
    assert not _faults(name, a, b)


@pytest.mark.parametrize("name", ["PyDecoder", "PyNvEncoder"])
def test_engine_classes_have_every_public_member(name):
    """Every public member of the reference's decoder and encoder
    (methods and properties) exists in the port."""
    a, b = _classes(name)
    missing = {m for m in dir(a) if not m.startswith("_")} - set(dir(b))
    assert not missing, sorted(missing)


def test_the_check_finds_a_shifted_parameter():
    """The check itself: a parameter dropped from the middle shifts the
    ones after it, and is reported; one dropped from the end is not."""
    def reference(settings, gpu_id=0, stream=None, format=1, verbose=False):
        pass

    def shifted(settings, gpu_id=0, format=1, verbose=False):
        pass

    def short(settings, gpu_id=0, stream=None):
        pass

    assert _faults("f", reference, shifted)
    assert not _faults("f", reference, short)


def test_encoder_takes_the_stream_third_in_both_packages():
    """PyNvEncoder(settings, gpu_id, stream, format): the third positional
    argument is the stream in both packages, the fourth the format."""
    settings = {"s": "64x48", "bf": "0"}
    for pkg in (ref, port):
        enc = pkg.PyNvEncoder(settings, 0, None, pkg.PixelFormat.NV12)
        assert (enc.Width, enc.Height) == (64, 48)
        assert enc.FrameSizeInBytes == 64 * 48 * 3 // 2
    yuv444 = port.PyNvEncoder(settings, 0, None, port.PixelFormat.YUV444)
    assert yuv444.FrameSizeInBytes == 64 * 48 * 3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from vali_tpu_torch.utils.synth import synthesize_clip

    return synthesize_clip(str(tmp_path_factory.mktemp("sig") / "c.mp4"),
                           64, 48, n=2)


def test_pipeline_takes_mesh_none_in_both_packages(clip):
    """mesh=None by keyword and in its positional place (between
    decode_threads and letterbox) in both packages."""
    for ms, gpu_id in ((ref_ms, 0), (port_ms, -1)):
        for pipe in (ms.MultiStreamPipeline([clip], 32, 32, gpu_id=gpu_id,
                                            mesh=None, letterbox=True),
                     ms.MultiStreamPipeline([clip], 32, 32, gpu_id, None,
                                            None, *_defaults(ms)[7:16],
                                            None, None, True)):
            assert pipe.letterbox is True
            batches = list(pipe)
            assert len(batches) == 2 and batches[0][0].shape[1:] == (32, 32,
                                                                     3)


def _defaults(ms):
    """The default values of MultiStreamPipeline's positional
    parameters, in order (self first)."""
    ps = inspect.signature(ms.MultiStreamPipeline.__init__).parameters
    return [p.default for p in ps.values()]


def _meshes(case):
    """(reference mesh, port mesh, batch_size) of a refusal case."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    cpus = [torch.device("cpu")] * 2
    if case == "no data axis":
        return (JaxMesh(np.array(jax.devices()[:2]), ("x",)),
                port_mesh.Mesh(np.array(cpus, dtype=object), ("x",)), 2)
    if case == "batch does not divide":
        return (ref_mesh.make_mesh(2, 1, jax.devices()[:2]),
                port_mesh.make_mesh(2, 1, devices=cpus), 3)
    return object(), object(), 2


@pytest.mark.parametrize("case", ["no data axis", "batch does not divide",
                                  "not a mesh"])
def test_port_pipeline_refuses_the_meshes_the_reference_refuses(clip,
                                                                 case):
    """A mesh without a "data" axis, a batch the data axis does not
    divide, and an object that is no mesh: the reference refuses each (the
    last with AttributeError, as it reads ``axis_names``), the port each
    with ValueError, by keyword and in the reference's positional place
    (never taken as letterbox)."""
    ref, ours, batch = _meshes(case)
    with pytest.raises((ValueError, AttributeError)):
        ref_ms.MultiStreamPipeline([clip], 32, 32, gpu_id=0,
                                   batch_size=batch, mesh=ref)
    with pytest.raises(ValueError, match="mesh"):
        port_ms.MultiStreamPipeline([clip], 32, 32, gpu_id=-1,
                                    batch_size=batch, mesh=ours)
    args = ([clip], 32, 32, -1, None, batch, *_defaults(port_ms)[7:16],
            None, ours)
    with pytest.raises(ValueError, match="mesh"):
        port_ms.MultiStreamPipeline(*args)


#: the public functions of parallel/mesh.py, reference name -> port name
MESH_FUNCTIONS = {"make_mesh": "make_mesh", "shard_planes": "shard_planes",
                  "sharded_preprocess": "sharded_preprocess",
                  "sharded_pallas_preprocess": "sharded_kernel_preprocess"}


@pytest.mark.parametrize("name", sorted(MESH_FUNCTIONS))
def test_mesh_functions_keep_the_reference_parameters(name):
    a = getattr(ref_mesh, name)
    b = getattr(port_mesh, MESH_FUNCTIONS[name])
    assert _params(a) == _params(b)
    assert not _faults(name, a, b)
