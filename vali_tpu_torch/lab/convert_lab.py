"""NV12 -> RGB convert lab: where the NV12 -> packed RGB kernel's time
goes, run on the card.

Counterpart of the TPU notebook ``convert_lab.py`` (its ``main`` and
``main_probe``). Two wrappers, each beside its plain PyTorch version, with
the same dispatch as the product wrappers: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version, any other device raises.
uint8 NV12 in, packed [B, H, 3W] uint8 out, BT.709 MPEG by default, bf16
coefficients (``ops/nv12_to_rgb.coefficients``).

- :func:`convert_variant` (``variant_kernel``, ``csrc/nv12_convert_staged.cu``;
  host tables ``lab/convert_staged.py``): a tile's luma, and its chroma
  replicated to full height, land by TMA, are converted to bf16 once into
  a shared-memory operand, and the CSC runs as ``wgmma`` products with the
  per-group matrices ``Ag`` and ``Bg``: ``V1`` luma x ``Ag16`` + chroma x
  ``Bg16`` per 16 pixels, ``V2`` one product over [luma 8 | chroma 8] x
  ``[Ag8; Bg8]`` per 8 pixels; the packed output is stored by TMA. Every
  bf16 coefficient times a uint8 sample is exact in fp32 and so is every
  partial sum, so both equal :func:`nv12_to_rgb` bit for bit.
- :func:`convert_probe` (``probe_kernel``, ``csrc/nv12_to_rgb_variants.cu``),
  one mode each:
  ``dma``: row 0 of the frame broadcast to every row of each of the three
  W-wide blocks of the [H, 3W] output (plane-blocked, not interleaved),
  while the whole frame is read; ``outonly``: the same output from 8 input
  rows; ``outband``: ``outonly`` stored by blocks of 216 output rows (the
  notebook's block reads 8 rows too); ``inonly``: [B, 8, 128], the sum of
  ``f[t:t+8, :128]`` over ``t in range(0, rows, 512)`` (``rows``: the
  buffer's rows as given, rows past it as 0) truncated to int, low byte,
  while the whole frame is read; ``noquant``: the full conversion stored as
  its truncated value's low byte (no round, no clip); ``noh``: the full
  conversion with output row ``r`` taking chroma row
  ``H + (r // 32) * 16 + r % 32`` in place of ``H + r // 2``, rows past the
  buffer as 0. On the card ``dma`` and ``inonly`` XOR every 32-bit word of
  the frames into a sink, so none of their loads is dead.

Together the probes split ``prod``'s time: read (``inonly``), store
(``outonly``, ``outband``), quantisation (``prod`` - ``noquant``) and chroma
replication (``prod`` - ``noh``).

Run the lab (64 x 1080p on ``cuda:0``; ``--device cpu`` runs the plain
versions at 2 x 256x144 and times nothing)::

    python -m vali_tpu_torch.lab.convert_lab [NAME ...] [--device cpu]

Names: ``prod`` (:func:`nv12_to_rgb` itself), ``V1``, ``V2``, ``dma``,
``inonly``, ``outonly``, ``outband``, ``noquant``, ``noh``. Each prints one
line: ms per batch, spread, maxdiff against its reference, GB/s and the
bound; on the card also the split as shares of ``prod``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops.nv12_to_rgb import (coefficients, csc_channels, nv12_to_rgb,
                               nv12_to_rgb_plain, pack_channels)
from .convert_staged import VARIANTS, staged_device
from .kernel_variants import SINK_WORDS, _on_cpu, make_frames
from .timing import bound_ms, convert_work, time_cuda

PROBES = {"dma": 0, "inonly": 1, "outonly": 2, "outband": 3, "noquant": 4,
          "noh": 5}
#: the inonly probe's output rows and lanes, and the row step of its sum
IN_ROWS, IN_LANES, IN_STEP = 8, 128, 512
#: noh: output rows per chroma copy (the notebook's TILE)
TILE = 32

DEFAULT_NAMES = ("prod", "V1", "V2", "dma", "inonly", "outonly", "outband",
                 "noquant", "noh")
CARD_SIZE = (64, 1920, 1080)   # batch, W, H
CPU_SIZE = (2, 256, 144)

_BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)


def _checked(nv12, src_w, src_h) -> None:
    """Validate a uint8 NV12 buffer [B, >= H*3/2, W]."""
    if (nv12.dim() != 3 or nv12.shape[1] < src_h * 3 // 2
            or nv12.shape[2] != src_w):
        raise ValueError(f"NV12 buffer shape {tuple(nv12.shape)} does not "
                         f"match {src_w}x{src_h}")
    if nv12.dtype != torch.uint8:
        raise ValueError(f"the convert lab takes uint8 samples, got "
                         f"{nv12.dtype}")
    if src_w % 2 or src_h % 2 or src_w <= 0 or src_h <= 0:
        raise ValueError(f"NV12 needs even, positive dims, got "
                         f"{src_w}x{src_h}")


def _coefficients(space: ColorSpace, crange: ColorRange) -> np.ndarray:
    """The product's 12 coefficients with bf16-rounded matrix (cached and
    read-only: shared by every call)."""
    return coefficients(space, crange, False, torch.bfloat16)


def _launch(what: str, launcher: str, nv12: torch.Tensor, *args,
            out: torch.Tensor) -> torch.Tensor:
    """One convert-lab launcher on a checked CUDA buffer: the frames, then
    ``args``, the output and the stream. The checks are what the probes'
    16-byte loads and the staged kernels' tensor maps need."""
    from ..ops._cuda_build import check, load_lab_kernels

    if (nv12.shape[2] % 16 or nv12.stride(2) != 1 or nv12.stride(1) % 16
            or nv12.stride(0) % 16 or nv12.data_ptr() % 16):
        raise ValueError(f"{what} on the card takes frames of a width that "
                         f"is a multiple of 16 with 16-byte aligned rows")
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = getattr(lib, launcher)(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), *args,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, what)
    return out


def _csc_plain(y: torch.Tensor, c: torch.Tensor, k: np.ndarray,
               quant: bool) -> torch.Tensor:
    """The product's arithmetic (:func:`csc_channels`) on float32 luma y
    [B, H, W] and interleaved chroma rows c [B, H, W] (one per output
    row), then round and clip, or (``quant`` False) the truncated value's
    low byte."""
    u = c[..., 0::2].repeat_interleave(2, dim=-1)
    v = c[..., 1::2].repeat_interleave(2, dim=-1)
    return pack_channels([
        torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8) if quant
        else (x.to(torch.int32) & 255).to(torch.uint8)
        for x in csc_channels(y, u, v, k)])


def _chroma_rows(nv12: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Buffer rows ``rows`` [H] of every frame as float32, rows at or past
    the buffer's end as 0."""
    n = nv12.shape[1]
    inside = (rows < n).to(torch.float32)[None, :, None]
    return nv12[:, rows.clamp(max=n - 1)].to(torch.float32) * inside


# --- the staged variants (notebook ``variant_kernel``) ---------------------

def convert_variant_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                          variant: str = "V1",
                          space: ColorSpace = ColorSpace.BT_709,
                          crange: ColorRange = ColorRange.MPEG
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`convert_variant` (any device): the
    product's plain version, whose bits the staged copies keep."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    _checked(nv12, src_w, src_h)
    return nv12_to_rgb_plain(nv12, src_w=src_w, src_h=src_h, space=space,
                             crange=crange)


def convert_variant(nv12: torch.Tensor, *, src_w: int, src_h: int,
                    variant: str = "V1",
                    space: ColorSpace = ColorSpace.BT_709,
                    crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """NV12 -> packed RGB [B, H, 3W] uint8 through a bf16 operand staged
    in shared memory and ``wgmma`` products (``variant`` V1: luma x Ag16 +
    chroma x Bg16, V2: [luma 8 | chroma 8] x [Ag8; Bg8]); equal to
    :func:`nv12_to_rgb`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    _checked(nv12, src_w, src_h)
    if _on_cpu("convert_variant", nv12):
        return convert_variant_plain(nv12, src_w=src_w, src_h=src_h,
                                     variant=variant, space=space,
                                     crange=crange)
    k = _coefficients(space, crange)
    out = torch.empty((nv12.shape[0], src_h, 3 * src_w), dtype=torch.uint8,
                      device=nv12.device)
    b = staged_device(space, crange, variant, nv12.device)
    _launch("convert_variant", "nv12_convert_staged_launch", nv12,
            nv12.shape[1], nv12.shape[0], src_h, src_w,
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            VARIANTS[variant], b.data_ptr(), out=out)
    convert_variant.launches += 1
    return out


# --- the probes (notebook ``probe_kernel``) --------------------------------

def convert_probe_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                        mode: str, space: ColorSpace = ColorSpace.BT_709,
                        crange: ColorRange = ColorRange.MPEG
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`convert_probe` (any device)."""
    if mode not in PROBES:
        raise ValueError(f"mode must be one of {tuple(PROBES)}, got "
                         f"{mode!r}")
    _checked(nv12, src_w, src_h)
    b, rows = nv12.shape[0], nv12.shape[1]
    if mode in ("dma", "outonly", "outband"):
        return nv12[:, :1].repeat(1, src_h, 3)
    if mode == "inonly":
        acc = torch.zeros((b, IN_ROWS, IN_LANES), dtype=torch.int32,
                          device=nv12.device)
        lanes = min(IN_LANES, src_w)
        for t in range(0, rows, IN_STEP):
            part = nv12[:, t:t + IN_ROWS, :lanes].to(torch.int32)
            acc[:, :part.shape[1], :lanes] += part
        return (acc & 255).to(torch.uint8)
    r = torch.arange(src_h, device=nv12.device)
    crow = (src_h + (r // TILE) * (TILE // 2) + r % TILE if mode == "noh"
            else src_h + r // 2)
    y = nv12[:, :src_h].to(torch.float32)
    return _csc_plain(y, _chroma_rows(nv12, crow), _coefficients(space,
                                                                 crange),
                      quant=mode == "noh")


def convert_probe(nv12: torch.Tensor, *, src_w: int, src_h: int, mode: str,
                  sink: Optional[torch.Tensor] = None,
                  space: ColorSpace = ColorSpace.BT_709,
                  crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """One probe of the NV12 -> RGB kernel's cost (``mode``: dma, inonly,
    outonly, outband, noquant, noh; see the module) -> [B, H, 3W] uint8, or
    [B, 8, 128] for inonly.

    On the card each block of dma and inonly XORs the words it read into
    one of the int32 words of ``sink`` (a fresh zeroed one of SINK_WORDS
    when None): the XOR of the sink after a call on a zeroed sink is the
    XOR of every 32-bit word of the frames. outonly and outband fold the
    first 8 rows of each frame into it."""
    if mode not in PROBES:
        raise ValueError(f"mode must be one of {tuple(PROBES)}, got "
                         f"{mode!r}")
    _checked(nv12, src_w, src_h)
    if _on_cpu("convert_probe", nv12):
        return convert_probe_plain(nv12, src_w=src_w, src_h=src_h,
                                   mode=mode, space=space, crange=crange)
    if sink is None:
        sink = torch.zeros(SINK_WORDS, dtype=torch.int32, device=nv12.device)
    if (sink.dtype != torch.int32 or sink.device != nv12.device
            or not sink.is_contiguous() or sink.numel() < 1):
        raise ValueError("sink must be a contiguous int32 tensor on the "
                         "frames' device")
    if mode in ("dma", "outonly", "outband") and src_w > 4096:
        raise ValueError(f"{mode} stages row 0 in 4096 bytes of shared "
                         f"memory: src_w={src_w} is wider")
    b = nv12.shape[0]
    shape = (b, IN_ROWS, IN_LANES) if mode == "inonly" else (b, src_h,
                                                             3 * src_w)
    out = torch.empty(shape, dtype=torch.uint8, device=nv12.device)
    k = _coefficients(space, crange)
    _launch("convert_probe", "nv12_convert_probe_launch", nv12,
            nv12.shape[1], b, src_h, src_w,
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), PROBES[mode],
            sink.data_ptr(), sink.numel(), out=out)
    convert_probe.launches += 1
    return out


#: kernel launches made by each wrapper (CPU calls are not counted)
convert_variant.launches = 0
convert_probe.launches = 0
WRAPPERS = (convert_variant, convert_probe)


# --- the lab ----------------------------------------------------------------

class Case(NamedTuple):
    """One lab name: the wrapper it launches, the call, the plain version
    of its function, the reference its maxdiff is taken against (every
    name must equal it bit for bit), and its work."""
    wrapper: Callable
    call: Callable[[torch.Tensor], torch.Tensor]
    plain: Callable[[torch.Tensor], torch.Tensor]
    reference: Callable[[torch.Tensor], torch.Tensor]
    work: tuple      # (bytes, operations) of one batch of B frames


def case(name: str, batch: int, rows: int, src_w: int, src_h: int) -> Case:
    """The :class:`Case` of a lab name on [batch, rows, src_w] frames: V1
    and V2 are held to :func:`nv12_to_rgb`, the probes to their plain
    versions. V1's and V2's operations are the FLOPs their products
    issue."""
    geo = dict(src_w=src_w, src_h=src_h, **_BT709)
    product = (lambda x: nv12_to_rgb(x, **geo))
    plain = (lambda x: nv12_to_rgb_plain(x, **geo))
    full = convert_work(batch, src_w, src_h, rows)
    if name == "prod":
        return Case(nv12_to_rgb, product, plain, product, full)
    if name in VARIANTS:
        return Case(convert_variant,
                    lambda x: convert_variant(x, **geo, variant=name),
                    lambda x: convert_variant_plain(x, **geo, variant=name),
                    product, convert_work(batch, src_w, src_h, rows,
                                          variant=name))
    if name in PROBES:
        probe_plain = (lambda x: convert_probe_plain(x, **geo, mode=name))
        return Case(convert_probe,
                    lambda x: convert_probe(x, **geo, mode=name),
                    probe_plain, probe_plain,
                    convert_work(batch, src_w, src_h, rows, name))
    raise ValueError(f"unknown lab name {name!r}: one of {DEFAULT_NAMES}")


def run(names: Sequence[str], frames: torch.Tensor, *, src_w: int,
        src_h: int, log: Callable[[str], None] = print
        ) -> List[Dict[str, object]]:
    """Run each lab name on ``frames`` [B, rows, src_w]: its maxdiff on the
    first three frames against its reference, and on the card its time per
    batch. Logs one line per name, and on the card the split as shares of
    ``prod``; returns one dict per name."""
    batch, rows = frames.shape[0], frames.shape[1]
    on_card = frames.device.type == "cuda"
    head = frames[:3]
    results = []
    for name in names:
        c = case(name, batch, rows, src_w, src_h)
        maxdiff = int((c.call(head).int() - c.reference(head).int()).abs()
                      .max().item())
        bound, bound_by = bound_ms(*c.work)
        row = dict(name=name, maxdiff=maxdiff, bound_ms=bound,
                   bound_by=bound_by, ms=None, spread=None)
        if on_card:
            ms, spread = time_cuda(c.call, frames)
            row.update(ms=ms, spread=spread,
                       gbps=c.work[0] / (ms * 1e-3) / 1e9)
            log(f"{name}: {ms:.4f} ms/batch  spread={spread:.1%}  "
                f"maxdiff={maxdiff}  GB/s={row['gbps']:.1f}  "
                f"bound={bound:.4f} ms ({bound_by})")
        else:
            log(f"{name}: maxdiff={maxdiff} (plain version on the CPU; "
                f"not timed)")
        results.append(row)
    t = {r["name"]: r["ms"] for r in results}
    if on_card and all(t.get(k) for k in DEFAULT_NAMES):
        p = t["prod"]
        log(f"split of prod {p:.4f} ms: read (inonly) {t['inonly'] / p:.1%}"
            f", store (outonly) {t['outonly'] / p:.1%}, store in 216-row "
            f"blocks (outband) {t['outband'] / p:.1%}, read + store (dma) "
            f"{t['dma'] / p:.1%}, quantisation (prod - noquant) "
            f"{(p - t['noquant']) / p:.1%}, chroma replication (prod - noh) "
            f"{(p - t['noh']) / p:.1%}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.convert_lab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("convert_lab: no CUDA device (use --device cpu for the "
                  "plain versions)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        batch, W, H = CARD_SIZE
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"{torch.cuda.get_device_name(0)} ({smi}) torch="
              f"{torch.__version__} cuda={torch.version.cuda}", flush=True)
    else:
        device = torch.device("cpu")
        batch, W, H = CPU_SIZE
    rows = H * 3 // 2
    print(f"{batch} x {W}x{H} NV12 (rows={rows}) -> packed RGB uint8, bf16 "
          f"coefficients, BT.709 MPEG", flush=True)
    frames = make_frames(batch, rows, W, device)
    run(args.names, frames, src_w=W, src_h=H,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
