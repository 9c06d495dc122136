"""The route of ``nv12_preprocess`` on the CPU: which kernel a call takes
on a card (``nv12_route``: the tensor-core kernel of
``csrc/nv12_wgmma_preprocess.cu`` or the FMA kernel of
``csrc/banded_preprocess.cu``), decided from the samples' dtype, the
compute and output dtypes and the geometry alone; and the tables the route
caches, S2's at 16-row strips over windows aligned to 8 rows, as
``tests/test_torch_port_static2_tables.py`` walks them."""

import numpy as np
import pytest
import torch

from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops import nv12_preprocess as nv12_mod
from vali_tpu_torch.ops.banded import core_matrix_order
from vali_tpu_torch.ops.resize import LANCZOS_AA

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
HD = (1920, 1080)


def _route(src_w, src_h, dst_w, dst_h, dtype=torch.uint8, batch=1, **kw):
    x = torch.zeros((batch, src_h * 3 // 2, src_w), dtype=dtype)
    return nv12_mod.nv12_route(x, src_w=src_w, src_h=src_h, dst_w=dst_w,
                               dst_h=dst_h, **kw)


@pytest.mark.parametrize("geo,dtype,kw,want", [
    # the north star, 64 x 1080p -> 224 uint8 / bf16 / uint8
    ((*HD, 224, 224), torch.uint8, {}, "wgmma"),
    # the letterbox launch's content shape
    ((*HD, 640, 360), torch.uint8, {}, "wgmma"),
    ((3840, 2160, 224, 224), torch.uint8, {}, "wgmma"),
    ((848, 464, 224, 224), torch.uint8, {}, "wgmma"),    # sample_profile
    ((*HD, 224, 224), torch.uint8,
     {"compute_dtype": torch.bfloat16}, "wgmma"),
    ((*HD, 224, 224), torch.uint16, {}, "banded"),       # P010 / P012
    ((*HD, 224, 224), torch.uint8,
     {"compute_dtype": torch.float32}, "banded"),
    ((*HD, 224, 224), torch.uint8,
     {"out_dtype": torch.bfloat16}, "banded"),
    ((*HD, 224, 224), torch.uint8,
     {"out_dtype": torch.float32}, "banded"),
    ((*HD, 224, 224), torch.uint8,
     {"out_dtype": torch.float32, "normalize": NORM}, "banded"),
    ((*HD, 640, 360), torch.uint8,
     {"out_dtype": torch.bfloat16, "normalize": NORM}, "banded"),
    # S2's windows need 407,936 B of shared memory against 232,448
    ((*HD, 32, 32), torch.uint8, {}, "banded"),
])
def test_route_follows_dtypes_and_geometry(geo, dtype, kw, want):
    """The route takes uint8 samples computed in bfloat16 into uint8 where
    S2's block at 16 rows takes the geometry, and nothing else; the batch
    does not move it."""
    assert _route(*geo, dtype=dtype, **kw) == want
    assert _route(*geo, dtype=dtype, batch=3, **kw) == want


#: the card tests' shapes, the lab's and the samples' (src_w, src_h,
#: dst_w, dst_h)
ACCEPTED = [(1920, 1080, 224, 224), (1920, 1080, 640, 360),
            (3840, 2160, 224, 224), (848, 464, 224, 224),
            (256, 96, 64, 32), (130, 62, 34, 30), (322, 150, 202, 70),
            (256, 96, 61, 37), (256, 144, 96, 64), (162, 90, 50, 20),
            (256, 144, 320, 200), (128, 64, 32, 32)]


@pytest.mark.parametrize("geo", ACCEPTED)
def test_refusal_accepts_the_shapes_the_route_runs(geo):
    """At 16-row strips over windows aligned to 8 rows S2's block takes
    every shape the main path, the samples and the card tests run, within
    a block's shared memory."""
    assert banded.static2_refusal(*geo, LANCZOS_AA, nv12_mod.WGMMA_TILE,
                                  nv12_mod.WGMMA_ALIGN) == ""
    assert _route(*geo) == "wgmma"


def test_refusal_names_shared_memory_and_odd_widths():
    why = banded.static2_refusal(*HD, 32, 32, LANCZOS_AA, 16, 8)
    assert "407936 B of shared memory" in why and "232448" in why
    assert "even width" in banded.static2_refusal(255, 144, 96, 64,
                                                  LANCZOS_AA, 16, 8)
    x = torch.zeros((1, 216, 255), dtype=torch.uint8)
    assert nv12_mod.nv12_route(x, src_w=255, src_h=144, dst_w=96,
                               dst_h=64) == "banded"


@pytest.mark.parametrize("geo", [(1920, 1080, 224, 224), (162, 90, 50, 20),
                                 (130, 62, 34, 30), (256, 144, 320, 200)])
def test_route_caches_s2_tables_at_16_rows(geo):
    """The route's cached tables are S2's at (16, 8) as
    test_torch_port_static2_tables.py walks them: B in core-matrix order,
    the window starts and K of each window, the W heads and fragments;
    the launch arguments point into them; one build a geometry, method
    and device."""
    cpu = torch.device("cpu")
    got = nv12_mod._wgmma_tables(*geo, LANCZOS_AA, cpu)
    assert nv12_mod._wgmma_tables(*geo, LANCZOS_AA, cpu) is got
    t, args = got
    want = banded.static2_tables(*geo, LANCZOS_AA, 16, 8)
    wt = banded.static2_w_tables(*geo, LANCZOS_AA)
    b = np.concatenate([core_matrix_order(want.luma),
                        core_matrix_order(want.chroma)], axis=1)
    assert t.b.dtype == t.frags.dtype == torch.bfloat16
    assert np.array_equal(t.b.float().numpy(), b)
    assert np.array_equal(t.starts.numpy(), want.starts)
    assert (t.k_luma, t.k_chroma) == (want.k_luma, want.k_chroma)
    assert np.array_equal(t.heads.numpy(), wt.heads)
    assert np.array_equal(t.frags.float().numpy(), wt.frags)
    assert args == (t.b.data_ptr(), t.starts.data_ptr(), t.k_luma,
                    t.k_chroma, t.heads.data_ptr(), t.frags.data_ptr())
    assert banded.static2_device_tables(*geo, LANCZOS_AA, 16, 8, cpu) is t


def test_refused_geometry_caches_none():
    cpu = torch.device("cpu")
    assert nv12_mod._wgmma_tables(*HD, 32, 32, LANCZOS_AA, cpu) is None


def test_route_raises_as_the_wrapper_does():
    """Arguments the wrapper refuses raise from the route too."""
    x = torch.zeros((1, 216, 256), dtype=torch.uint8)
    geo = dict(src_w=256, src_h=144, dst_w=96, dst_h=64)
    with pytest.raises(ValueError, match="normalize requires"):
        nv12_mod.nv12_route(x, **geo, normalize=NORM)
    with pytest.raises(ValueError, match="bfloat16 cannot hold"):
        nv12_mod.nv12_route(x.to(torch.int16).view(torch.uint16), **geo,
                            compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        nv12_mod.nv12_route(x, **dict(geo, src_w=128))


def test_cpu_calls_run_the_plain_version_and_count_no_route():
    """A CPU tensor runs the plain version: no launch, no route counted."""
    from vali_tpu_torch.utils import tracing

    x = torch.randint(0, 256, (1, 216, 256), dtype=torch.uint8)
    geo = dict(src_w=256, src_h=144, dst_w=96, dst_h=64)
    before = tracing.counters()
    out = nv12_mod.nv12_preprocess(x, **geo)
    assert torch.equal(out, nv12_mod.nv12_preprocess_plain(x, **geo))
    after = tracing.counters()
    for key in ("routes.nv12_preprocess.wgmma",
                "routes.nv12_preprocess.banded",
                "launches.nv12_preprocess"):
        assert after.get(key, 0) == before.get(key, 0)
