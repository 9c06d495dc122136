"""Each reference against the port's plain route on CPU tensors at small
sizes, the control against the cells' limits, and the generator's
determinism.

With float32 compute the port's plain routes round the exact answer, so
each output sample lies within half an LSB of the reference (plus float32
rounding of the sums); with the default bfloat16 compute they stay
within the cell's limit. The control, the reference one precision down,
lies beyond it."""

import json
import os

import pytest
import torch

from perfbench import compare, harness
from perfbench.generators import yuv420
from perfbench.reference import (CONTROL_BELOW, convert_resize, lanczos,
                                 nv12_resize, preprocess)

SMALL = dict(width=192, height=108, dst_width=32, dst_height=24)
SMALL_4K = dict(width=384, height=216, dst_width=192, dst_height=108)
CONTENT = {"cell_px": 16, "noise": 24}
CELLS = [w["name"] for w in harness.manifest()["workloads"]]
#: float32 sums of a few hundred taps on 8-bit samples
F32_SLACK = 0.5 + 0.05


def config(name, sizes):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return {**json.load(f), **sizes}


def frames(fmt, b, h, w, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return yuv420.make_batch(g, fmt, b, h, w, CONTENT, torch.device("cpu"))


def gap(a, b):
    return float((a.to(torch.float64) - b).abs().max())


def port_kw(cfg, cdt):
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace

    return dict(src_w=cfg["width"], src_h=cfg["height"],
                dst_w=cfg["dst_width"], dst_h=cfg["dst_height"],
                space=ColorSpace[cfg["color_space"]],
                crange=ColorRange[cfg["color_range"]], compute_dtype=cdt)


@pytest.mark.parametrize("fmt", ["NV12", "I420"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_preprocess_reference_against_the_plain_route(fmt, cdt):
    from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess_plain
    from vali_tpu_torch.ops.yuv420_preprocess import yuv420_preprocess_plain

    cfg = config("stream64_1080p_224", SMALL)
    planes = frames(fmt, 3, 108, 192)
    want = preprocess.compute(planes, fmt, cfg)[0]
    plain = nv12_preprocess_plain if fmt == "NV12" else \
        yuv420_preprocess_plain
    got = plain(*planes, **port_kw(cfg, cdt)).movedim(1, -1)
    cell = "fused_nv12_b64" if fmt == "NV12" else "fused_i420_b64"
    bound = (F32_SLACK if cdt == torch.float32
             else compare.limits(cell)["max_err_lsb.rgb"])
    assert gap(got, want) <= bound


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_convert_resize_reference_against_the_plain_route(cdt):
    from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb_plain
    from vali_tpu_torch.ops.packed_resize import packed_resize_plain

    cfg = config("stream64_1080p_224", SMALL)
    planes = frames("NV12", 3, 108, 192)
    rgb_want, small_want = convert_resize.compute(planes, "NV12", cfg)
    kw = port_kw(cfg, cdt)
    rgb = nv12_to_rgb_plain(planes[0], src_w=kw["src_w"], src_h=kw["src_h"],
                            space=kw["space"], crange=kw["crange"],
                            compute_dtype=cdt)
    small = packed_resize_plain(rgb, src_w=kw["src_w"], src_h=kw["src_h"],
                                dst_w=kw["dst_w"], dst_h=kw["dst_h"],
                                compute_dtype=cdt)
    limits = compare.limits("two_stage_nv12_b64")
    if cdt == torch.float32:
        # the surface is the same rounding; the resize's float32 weights
        assert gap(rgb, rgb_want) <= F32_SLACK
        assert gap(small, small_want) <= F32_SLACK
    else:
        assert gap(rgb, rgb_want) <= limits["max_err_lsb.rgb"]
        assert gap(small, small_want) <= limits["max_err_lsb.small"]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_nv12_resize_reference_against_the_plain_route(cdt):
    from vali_tpu_torch.ops.nv12_resize import nv12_resize_plain

    cfg = config("transcode_4k_1080p", SMALL_4K)
    planes = frames("NV12", 2, 216, 384)
    want = nv12_resize.compute(planes, "NV12", cfg)[0]
    got = nv12_resize_plain(planes[0], src_w=384, src_h=216, dst_w=192,
                            dst_h=108, compute_dtype=cdt)
    bound = (F32_SLACK if cdt == torch.float32
             else compare.limits("resize_4k_nv12_b16")["max_err_lsb.nv12"])
    assert gap(got, want) <= bound


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(small_cells, cell):
    c = harness.cell(cell)
    cfg, traffic, path = c.config, c.traffic, c.path
    planes = frames(traffic["format"], 2, cfg["height"], cfg["width"])
    call = compare.control_call(path, cfg, traffic)
    readings = compare.gaps([(0, call(planes))], [planes], path, cfg,
                            traffic)
    correct, _ = compare.judged(readings, compare.limits(cell))
    assert CONTROL_BELOW[cfg["compute_dtype"]] == "float8_e4m3fn"
    assert not correct


def test_frozen_weights_match_the_ports_at_freeze_time():
    from vali_tpu_torch.ops.fused import _chroma_weights
    from vali_tpu_torch.ops.resize import LANCZOS_AA, resize_weights

    rs = config("stream64_1080p_224", {})["resample"]
    for n_in, n_out in ((1080, 224), (1920, 224), (2160, 1080), (960, 480)):
        assert abs(lanczos.plane_weights(n_in, n_out, rs)
                   - resize_weights(n_in, n_out, LANCZOS_AA)).max() < 1e-6
    for n_in, n_out, full in ((540, 224, 1080), (960, 224, 1920)):
        assert abs(lanczos.chroma_weights(n_in, n_out, full, 0.5, rs)
                   - _chroma_weights(n_in, n_out, full, LANCZOS_AA)
                   ).max() < 1e-6


def test_the_generator_repeats_a_seed_and_not_another():
    a = frames("I420", 2, 108, 192, seed=2**31 + 11)
    b = frames("I420", 2, 108, 192, seed=2**31 + 11)
    c = frames("I420", 2, 108, 192, seed=2**31 + 12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    # the I420 planes are views of one buffer, as BatchStager carves it
    storage = {p.untyped_storage().data_ptr() for p in a}
    assert len(storage) == 1
