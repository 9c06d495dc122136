"""vali_tpu_torch's NV12 -> RGB convert lab against the TPU notebook
``convert_lab.py`` on the CPU: the same numpy-seeded NV12 buffer goes
through each notebook kernel in interpret mode and through the port's
wrapper on a CPU tensor (its plain version). Every name agrees bit for bit:
the staged variants also with the product's plain version, ``noquant`` as
its low byte (uint8 wraps modulo 256).

The notebook builds a 64 x 1080p NV12 array when it is imported and fixes
its geometry in module globals (``H, W``), caching its jitted functions by
input shape, so this module imports it once, in a fixture, sets the
globals to one geometry and restores them afterwards. H = 216 is one of
``outband``'s 216-row blocks (the notebook leaves the rows past its last
whole block unwritten). There the notebook's ``noh`` reads output rows
204..215 from chroma rows 324..335, past the frame's 324 rows, and its
windows reach row 343: its input carries PAD zero rows so that they stay
inside the buffer, and the port reads rows past an unpadded buffer as 0."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vali_tpu_torch.core.enums import ColorRange, ColorSpace  # noqa: E402
from vali_tpu_torch.lab import convert_lab as cl  # noqa: E402
from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb_plain  # noqa: E402

B, H, W = 2, 216, 256
PAD = 20   # rows the notebook's noh windows read past H*3/2
GEO = dict(src_w=W, src_h=H)
BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)


@pytest.fixture(scope="module")
def nb():
    mod = importlib.import_module("convert_lab")
    saved = (mod.H, mod.W)
    mod.H, mod.W = H, W
    with pltpu.force_tpu_interpret_mode(
            pltpu.InterpretParams(uninitialized_memory="zero")):
        yield mod
    mod.H, mod.W = saved


@pytest.fixture(scope="module")
def nv12():
    """[B, H*3/2 + PAD, W] uint8: random samples, zero pad rows."""
    x = np.zeros((B, H * 3 // 2 + PAD, W), np.uint8)
    x[:, :H * 3 // 2] = np.random.default_rng(0).integers(
        0, 256, (B, H * 3 // 2, W), dtype=np.uint8)
    return x


@pytest.fixture(scope="module")
def bright(nv12):
    """Luma 255 and V 255 on the even frame, luma 0 and U 0 on the odd:
    the conversion leaves [0, 255] on both sides, which pins noquant's
    truncation and low byte."""
    x = nv12.copy()
    x[0, :H], x[1, :H] = 255, 0
    x[0, H:H * 3 // 2, 1::2] = 255
    x[1, H:H * 3 // 2, 0::2] = 0
    return x


@pytest.mark.parametrize("variant", ["V1", "V2"])
def test_variants_match_the_notebook_bit_for_bit(nb, nv12, variant):
    j = np.asarray(nb.variant_kernel(jnp.asarray(nv12), variant=variant))
    x = torch.from_numpy(nv12)
    t = cl.convert_variant(x, **GEO, variant=variant)
    assert np.array_equal(j, t.numpy())
    assert torch.equal(t, nv12_to_rgb_plain(x, **GEO, **BT709))


@pytest.mark.parametrize("mode", list(cl.PROBES))
@pytest.mark.parametrize("frames", ["nv12", "bright"])
def test_probes_match_the_notebook(request, nb, mode, frames):
    """Bit for bit, on the padded buffer and on the frame's own H*3/2
    rows (the port reads rows past the buffer as the notebook's zero pad
    rows)."""
    x = request.getfixturevalue(frames)
    j = np.asarray(nb.probe_kernel(jnp.asarray(x), mode=mode))
    for rows in (x.shape[1], H * 3 // 2):
        t = cl.convert_probe(torch.from_numpy(x[:, :rows]), **GEO, mode=mode)
        assert np.array_equal(j, t.numpy()), rows


def test_noh_reads_past_the_frame_as_zero(nv12):
    """Output rows whose noh chroma row lies past the buffer convert with
    U = V = 0; the rows before them with their own chroma copy."""
    x = torch.from_numpy(nv12[:, :H * 3 // 2])
    r = np.arange(H)
    crow = H + (r // cl.TILE) * (cl.TILE // 2) + r % cl.TILE
    past = crow >= H * 3 // 2
    assert past.any() and not past.all()
    out = cl.convert_probe(x, **GEO, mode="noh")
    k = cl._coefficients(ColorSpace.BT_709, ColorRange.MPEG)
    y = x[:, :H].float()
    for ch in range(3):
        v = torch.clamp(torch.round(y * float(k[3 * ch]) + float(k[9 + ch])),
                        0, 255).to(torch.uint8)
        assert torch.equal(out[:, past, ch::3], v[:, past])
        assert not torch.equal(out[:, ~past, ch::3], v[:, ~past])


def test_noquant_keeps_the_low_byte_of_the_truncated_value(bright):
    """Where the conversion leaves [0, 255] noquant stores the truncated
    value's low byte, the product its clipped round."""
    x = torch.from_numpy(bright)
    nq = cl.convert_probe(x, **GEO, mode="noquant")
    prod = nv12_to_rgb_plain(x, **GEO, **BT709)
    k = cl._coefficients(ColorSpace.BT_709, ColorRange.MPEG)
    y = 255.0   # frame 0: Y = 255, V = 255 -> red far above 255
    red = (y * float(k[0]) + (float(x[0, H, 0]) * float(k[1])
                              + 255.0 * float(k[2]))) + float(k[9])
    assert red > 256
    assert int(nq[0, 0, 0]) == int(np.trunc(np.float32(red))) % 256
    assert int(prod[0, 0, 0]) == 255
    # frame 1: Y = 0, U = 0 -> green above 255, blue below 0
    assert (nq[1] != prod[1]).any()


def test_wrappers_reject_bad_arguments(nv12):
    x = torch.from_numpy(nv12)
    before = [w.launches for w in cl.WRAPPERS]
    with pytest.raises(ValueError, match="variant"):
        cl.convert_variant(x, **GEO, variant="V0")
    with pytest.raises(ValueError, match="variant"):
        cl.convert_variant_plain(x, **GEO, variant="V3")
    with pytest.raises(ValueError, match="mode"):
        cl.convert_probe(x, **GEO, mode="prod")
    with pytest.raises(ValueError, match="mode"):
        cl.convert_probe_plain(x, **GEO, mode="dma_only")
    with pytest.raises(ValueError, match="uint8"):
        cl.convert_variant(x.to(torch.int16), **GEO)
    with pytest.raises(ValueError, match="does not match"):
        cl.convert_probe(x[:, :H * 3 // 2 - 1], **GEO, mode="dma")
    with pytest.raises(ValueError, match="does not match"):
        cl.convert_variant(x[:, :, :W - 16], **GEO)
    with pytest.raises(ValueError, match="even"):
        cl.convert_probe(x, src_w=W, src_h=H - 1, mode="noh")
    for wrapper, kw in ((cl.convert_variant, {}),
                        (cl.convert_probe, dict(mode="dma"))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            wrapper(x.to("meta"), **GEO, **kw)
    cl.convert_probe(x, **GEO, mode="inonly")  # a plain version: no launch
    assert [w.launches for w in cl.WRAPPERS] == before
    with pytest.raises(ValueError, match="unknown lab name"):
        cl.case("V0", B, H * 3 // 2, **GEO)


def test_lab_entry_point_on_the_cpu(capsys):
    """The lab's CPU route runs every default name on the plain versions
    and reports maxdiff 0 against the references, timing nothing."""
    assert cl.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    per_name = [ln for ln in lines if "maxdiff=" in ln]
    assert [ln.split(":")[0] for ln in per_name] == list(cl.DEFAULT_NAMES)
    assert all("maxdiff=0 " in ln for ln in per_name)


def test_work_gives_the_bounds_at_64_x_1080p():
    """Bytes bound every name: the full function 199 MB in + 398 MB out,
    the 8-row-input probes the output alone, inonly the frames alone."""
    from vali_tpu_torch.lab.timing import bound_ms

    b, w, h = cl.CARD_SIZE
    rows = h * 3 // 2
    want = {"prod": 0.178, "V1": 0.178, "V2": 0.178, "dma": 0.178,
            "noquant": 0.178, "noh": 0.178, "outonly": 0.119,
            "outband": 0.119, "inonly": 0.059}
    for name, ms in want.items():
        bound, by = bound_ms(*cl.case(name, b, rows, w, h).work)
        assert by == "bytes" and bound == pytest.approx(ms, abs=1e-3), name
