"""The NV12 lab's prod_like on S2's block (``csrc/nv12_prodlike.cu``, host
side ``vali_tpu_torch.lab.prodlike``; full at S2's strip heights is S2's
kernel) and multiframe's 8-frame walk (``csrc/nv12_combo.cu``'s rounds
split) on the CPU: a numpy replay of the block in each mode — full at
every strip height (4-row strips at wgmma's N = 8), hpass's column
ownership, wpass's ring rows and its even / odd
chroma bytes — through the tables the kernel reads, within the uint8
envelope of the plain versions, every output sample stored once; M8's
walk of every (frame, chunk) within 96 accumulators a thread; the work
the lab counts; the shared memory; the instances the source compiles; and
the refusals before any launch."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.lab import prodlike as pl
from vali_tpu_torch.ops import _cuda_build, banded
from vali_tpu_torch.ops.resize import LANCZOS_AA

from tests.test_torch_port_combo_tables import _walk as _combo_walk
from tests.test_torch_port_static2_tables import _w_as_read

#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(1920, 1080, 224, 224), (162, 90, 50, 20), (130, 62, 34, 30),
              (256, 96, 48, 40), (256, 144, 96, 64), (322, 150, 202, 70)]
INSTANCES = [(m, t) for m, ts in pl.PRODLIKE_STRIPS.items() for t in ts]


def _frames(geo, batch, seed, pad=0):
    src_w, src_h = geo[:2]
    return np.random.default_rng(seed).integers(
        0, 256, (batch, src_h * 3 // 2 + pad, src_w), dtype=np.uint8)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _read_b(flat, n, k):
    """[strips, n, k] of one B from [strips, n k] in core-matrix order, as
    the kernel's descriptor reads it: element (row n_, k_) at (k_ // 16) n
    16 + (n_ // 8) 128 + (k_ mod 16 // 8) 64 + (n_ mod 8) 8 + k_ mod 8
    (k-steps N * 32 bytes apart, 8-row groups 256 bytes, K halves 128)."""
    r = np.arange(n)[:, None]
    c = np.arange(k)[None, :]
    idx = ((c // 16) * n * 16 + (r // 8) * 128 + (c % 16 // 8) * 64
           + (r % 8) * 8 + c % 8)
    return flat[:, idx]


def _plain(x, geo, mode, tile):
    src_w, src_h, dst_w, dst_h = geo
    return kv.prod_like_plain(torch.from_numpy(x), src_w=src_w, src_h=src_h,
                              dst_w=dst_w, dst_h=dst_h, mode=mode,
                              rows_per_block=tile).numpy()


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def _walk(nv12, geo, mode, tile):
    """prod_like's blocks in numpy, as nv12_prodlike.cu runs them: per
    (strip, tile, frame) the ring's stages of 128 frame bytes from x0 (the
    strip's stacked windows, or wpass's frame rows), warpgroup w taking
    chunk 2 s + w of stage s; full and hpass multiply B (prodlike_b, read
    as the descriptor reads it, N = prodlike_n(tile)) into bf16 sums,
    wpass takes the ring's bytes as they are; hpass stores clip(round(yh
    + ch)) at the columns its tile owns, the others run the W products
    (S2's fragments) and the tail. Returns the output and how many times
    each sample was stored."""
    src_w, src_h, dst_w, dst_h = geo
    b, buf_rows = nv12.shape[:2]
    n = pl.prodlike_n(tile)
    t = banded.static2_tables(*geo, LANCZOS_AA, tile, pl.PRODLIKE_ALIGN)
    wt = banded.static2_w_tables(*geo, LANCZOS_AA)
    ky, kc = (tile, tile) if mode == "wpass" else (t.k_luma, t.k_chroma)
    flat = pl.prodlike_b(*geo, tile)
    by = _read_b(flat[:, :n * t.k_luma], n, t.k_luma)
    bc = _read_b(flat[:, n * t.k_luma:], n, t.k_chroma)
    own = pl.hpass_owners(*geo) if mode == "hpass" else None
    strips = -(-dst_h // tile)
    rng = np.random.default_rng(7)
    out = np.zeros((b, 3, dst_h, dst_w), np.uint8)
    count = np.zeros(out.shape, np.int64)
    sums = np.zeros((3, b, strips * tile, dst_w), np.float32)
    for strip in range(strips):
        o0 = strip * tile
        rows_n = min(tile, dst_h - o0)
        if mode == "wpass":
            rows = pl.wpass_ring_rows(tile, o0, dst_h, buf_rows)
        else:
            rows = np.concatenate([
                np.minimum(t.starts[strip, 0] + np.arange(ky), src_h - 1),
                src_h + np.minimum(t.starts[strip, 1] + np.arange(kc),
                                   src_h // 2 - 1)])
        for tile_i in range(wt.heads.shape[0]):
            x0, chunks, ay, ac = _w_as_read(wt, tile_i)
            for z in range(b):
                acc = np.zeros((3, n, 64), np.float32)
                for s in range(chunks // 2):
                    # stale bytes past a row: anything, since they weigh 0
                    # (W) or are no column the block owns (hpass)
                    slot = rng.integers(0, 256, (ky + kc, 128)).astype(
                        np.float32)
                    c = min(128, max(0, src_w - x0 - 128 * s))
                    slot[:, :c] = nv12[z][rows, x0 + 128 * s:
                                          x0 + 128 * s + c]
                    for wg in range(2):
                        a = slot[:, 64 * wg:64 * wg + 64]
                        chunk = 2 * s + wg
                        if mode == "wpass":   # exact in bf16
                            hy, hc = a[:ky], a[ky:]
                        else:
                            hy = _bf16(by[strip] @ a[:ky])
                            hc = _bf16(bc[strip] @ a[ky:])
                            # B's zero columns past the strip: zero sums
                            assert not hy[tile:].any() and not hc[tile:].any()
                        if mode == "hpass":
                            p = x0 + 128 * s + 64 * wg + np.arange(64)
                            m = (p >= own[tile_i, 0]) & (p < own[tile_i, 1])
                            q = np.clip(np.rint(hy + hc), 0, 255)
                            for r in range(rows_n):
                                out[z, :, o0 + r, p[m]] = q[r, m].astype(
                                    np.uint8)[:, None]
                                count[z, :, o0 + r, p[m]] += 1
                            continue
                        # luma rows; U from the even bytes, V from the odd
                        for ch, (h, w, cols) in enumerate((
                                (hy, ay, 64), (hc[:, 0::2], ac, 32),
                                (hc[:, 1::2], ac, 32))):
                            acc[ch] += np.einsum(
                                "mk,rk->rm",
                                w[:, cols * chunk:cols * (chunk + 1)], h)
                if mode != "hpass":
                    p0 = 64 * tile_i
                    m = min(64, dst_w - p0)
                    sums[:, z, o0:o0 + rows_n, p0:p0 + m] = \
                        acc[:, :rows_n, :m]
                    count[z, :, o0:o0 + rows_n, p0:p0 + m] += 1
    if mode != "hpass":
        eye = torch.eye(dst_w)
        tail = banded.tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0,
                                  torch.uint8, None)
        y, u, v = (torch.from_numpy(x[:, :dst_h]) for x in sums)
        out = banded.w_pass_tail_plain(y, u, v, eye, eye, tail,
                                       torch.uint8).numpy()
    return out, count


@pytest.mark.parametrize("mode,tile", INSTANCES)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_walk_is_within_the_envelope_of_the_plain_version(geo, mode, tile):
    """Each instance's replay lies within 1 LSB of its plain version on
    fewer than 1e-3 of the samples (fp32 sums in another order), and
    stores every output sample exactly once: hpass each column from the
    block that owns it, the others each strip's rows < its height (a
    4-row strip's rows 4-7, N = 8's, are never stored)."""
    big = geo[0] > 400
    x = _frames(geo, 1 if big else 2, sum(geo) + tile, pad=0 if big else 8)
    got, count = _walk(x, geo, mode, tile)
    assert (count == 1).all()
    _close(got, _plain(x, geo, mode, tile))


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_hpass_owners_store_each_column_once_from_a_chunk_that_holds_it(
        geo):
    """Walking every thread's two byte columns of every stage of every
    tile, the columns hpass stores cover 0 .. DW - 1 once each, each from
    a chunk whose 64 bytes hold it, the lowest tile that holds it."""
    src_w, src_h, dst_w, dst_h = geo
    own = pl.hpass_owners(*geo)
    heads = banded.static2_w_tables(*geo, LANCZOS_AA).heads
    stores = np.zeros(dst_w, np.int64)
    lane = np.arange(32)
    for tile_i, (_, x0, chunks, _) in enumerate(heads):
        for s in range(chunks // 2):
            for wg in range(2):
                for warp in range(4):
                    lcol = 16 * warp + 2 * (lane // 4)   # tq repeats them
                    for c in range(2):
                        p = x0 + 128 * s + 64 * wg + lcol[lane % 4 == 0] + c
                        m = (p >= own[tile_i, 0]) & (p < own[tile_i, 1])
                        chunk0 = x0 + 64 * (2 * s + wg)
                        assert ((chunk0 <= p[m]) & (p[m] < chunk0 + 64)).all()
                        stores[p[m]] += 1
    assert (stores == 1).all()
    x0 = heads[:, 1]
    end = x0 + 64 * heads[:, 2]
    for p in range(dst_w):
        holds = np.flatnonzero((x0 <= p) & (p < end))
        lo, hi = own[holds[0]]
        assert lo <= p < hi
    assert (own[:, 1] <= dst_w).all() and own.dtype == np.int32


def test_hpass_owners_at_1080p_are_tile_0s():
    """At 1080p -> 224 tile 0's chunks (x0 0, 10 chunks: 640 bytes) hold
    every column below 224: its blocks store them all, the others none."""
    own = pl.hpass_owners(1920, 1080, 224, 224)
    assert own.tolist() == [[0, 224], [0, 0], [0, 0], [0, 0]]
    heads = banded.static2_w_tables(1920, 1080, 224, 224, LANCZOS_AA).heads
    assert tuple(heads[0, 1:3]) == (0, 10)


def test_hpass_tolerance_is_one_lsb_plus_the_bf16_ulps():
    """hpass stores round(bf16(yh) + bf16(ch)): its bound is 1 LSB where
    both H sums are under 64, and one bf16 ulp of each sum more above (1
    at 128-255, 2 at 256-511); the replay of the kernel lies within it."""
    geo = (256, 144, 96, 64)
    x = _frames(geo, 2, 11)
    kw = dict(zip(("src_w", "src_h", "dst_w", "dst_h"), geo))
    tol = kv.hpass_tolerance(torch.from_numpy(x), **kw)
    yh, ch = kv._hpass_sums(torch.from_numpy(x), **kw)
    small = (yh.abs() < 64) & (ch.abs() < 64)
    assert (tol[:, 0][small] == 1).all() and small.any()
    mid = (yh >= 128) & (yh < 256) & (ch.abs() < 128)
    assert (tol[:, 0][mid] == 2).all() and mid.any()
    assert tol.shape == (2, 3, 64, 96) and int(tol.max()) <= 5
    got, _ = _walk(x, geo, "hpass", 16)
    d = np.abs(got.astype(int) - _plain(x, geo, "hpass", 16).astype(int))
    assert (d <= tol.numpy()).all()


@pytest.mark.parametrize("tile", [16, 32])
def test_wpass_ring_rows_and_chroma_bytes(tile):
    """wpass's ring carries the strip's rows o0 .. and buf_rows - DH + o0
    .. of the buffer as given (clamped to its last row past DH), and its
    chroma H rows take U from the even bytes and V from the odd."""
    dst_h, buf_rows = 40, 100
    for o0 in range(0, dst_h, tile):
        rows = pl.wpass_ring_rows(tile, o0, dst_h, buf_rows)
        r = np.arange(tile)
        assert rows[:tile].tolist() == (o0 + r).tolist()
        want = np.minimum(buf_rows - dst_h + o0 + r, buf_rows - 1)
        assert rows[tile:].tolist() == want.tolist()
        stored = o0 + r < dst_h
        assert (rows[tile:][stored] == buf_rows - dst_h + o0 + r[stored]).all()
    # a buffer whose U bytes are 0 and V bytes 255: the walk's wpass gives
    # the plain version's colours, so U and V were not swapped
    geo = (256, 96, 48, 40)
    x = _frames(geo, 1, 3, pad=8)
    x[:, -geo[3]:, 0::2] = 0
    x[:, -geo[3]:, 1::2] = 255
    got, _ = _walk(x, geo, "wpass", tile)
    _close(got, _plain(x, geo, "wpass", tile))
    y = x.copy()
    y[:, -geo[3]:, 0::2], y[:, -geo[3]:, 1::2] = 255, 0
    assert not np.array_equal(_plain(y, geo, "wpass", tile), got)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_four_row_strips_run_n8_with_zero_columns(geo):
    """prodlike_b at 4-row strips is S2's B_y and B_c at (4, 8) in columns
    0-3 and zero in columns 4-7 (N = 8), read back as the kernel's
    descriptor reads it; at S2's strip heights it is S2's own B."""
    t4 = banded.static2_tables(*geo, LANCZOS_AA, 4, 8)
    flat = pl.prodlike_b(*geo, 4)
    assert flat.shape == (t4.luma.shape[0], 8 * (t4.k_luma + t4.k_chroma))
    by = _read_b(flat[:, :8 * t4.k_luma], 8, t4.k_luma)
    bc = _read_b(flat[:, 8 * t4.k_luma:], 8, t4.k_chroma)
    assert np.array_equal(by[:, :4], t4.luma)
    assert np.array_equal(bc[:, :4], t4.chroma)
    assert not by[:, 4:].any() and not bc[:, 4:].any()
    for tile in (8, 16, 32):
        t = banded.static2_tables(*geo, LANCZOS_AA, tile, 8)
        s2 = np.concatenate([banded.core_matrix_order(t.luma),
                             banded.core_matrix_order(t.chroma)], axis=1)
        assert np.array_equal(pl.prodlike_b(*geo, tile), s2)


@pytest.mark.parametrize("geo", GEOMETRIES[1:])
def test_m8_walks_every_frame_and_chunk_once_within_96_accumulators(geo):
    """The combo's rounds split at (8, 32): each block's two warpgroups
    take every (frame, chunk) of its 8 frames exactly once over two
    rounds of 4 frames, hold at most 96 fp32 W accumulators a thread, load
    each chunk's W fragments once a round, and the replay lies within the
    envelope of static_kernel2_plain at (32, 8)."""
    assert banded.COMBO_SPLITS[8, 32] == "rounds"
    x = _frames(geo, 8, sum(geo))
    got, frag, visits, most = _combo_walk(x, geo, 8, 32)
    heads = banded.static2_w_tables(*geo, LANCZOS_AA).heads
    want = {int(c): sorted((f, q) for f in range(8) for q in range(c))
            for c in heads[:, 2]}
    assert len(visits) == -(-geo[3] // 32) * len(heads)
    for i, seen in enumerate(visits):
        chunks = int(heads[i % len(heads), 2])
        assert sorted(seen) == want[chunks]
    assert most == 96
    assert frag == kv.combo_w_fragment_bytes(8, *geo, gframes=8, tile=32)
    src_w, src_h, dst_w, dst_h = geo
    plain = kv.static_kernel2_plain(torch.from_numpy(x), src_w=src_w,
                                    src_h=src_h, dst_w=dst_w, dst_h=dst_h,
                                    tile=32, align=8).numpy()
    _close(got, plain)


def test_work_is_s2s_for_full_and_splits_into_h_and_w():
    """prodlike_work: full counts S2's issued FLOPs at every strip height
    S2 runs; wpass the W k-steps (and the tail), so that full less wpass
    is every H chain, and reads two DH-row slabs (55 MB a 64 x 1080p
    batch); hpass what its output needs, the luma and interleaved chroma
    bytes of the first DW columns (23 MB) and their H sums at N (and an
    add and a round a pixel); 4-row strips issue N = 8."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    b = 64
    for tile in banded.STATIC2_TILES:
        assert kv.prodlike_work(b, **geo, mode="full", tile=tile) == \
            kv.static2_work(b, **geo, tile=tile, align=8)
    out = b * 3 * 224 * 224
    chunks = int(banded.static2_w_tables(*geo.values(),
                                         LANCZOS_AA).heads[:, 2].sum())
    for tile in (4, 16, 32):
        t = banded.static2_tables(*geo.values(), LANCZOS_AA, tile, 8)
        n_strips = max(tile, 8) * t.luma.shape[0]
        k = t.k_luma + t.k_chroma
        full = kv.prodlike_work(b, **geo, mode="full", tile=tile)
        h = kv.prodlike_work(b, **geo, mode="hpass", tile=tile)
        w = kv.prodlike_work(b, **geo, mode="wpass", tile=tile)
        assert full[0] == b * 1620 * 1920 + out
        assert h[0] == b * 1620 * 224 + out == 23224320 + out
        assert w[0] == b * 2 * 224 * 1920 + out == 55050240 + out
        assert full[1] - w[1] == b * 2 * 64 * n_strips * chunks * k
        assert h[1] == b * 2 * (n_strips * k * 224 + 224 * 224)
    t4 = banded.static2_tables(*geo.values(), LANCZOS_AA, 4, 8)
    assert t4.luma.shape[0] == 56
    for name, mode, tile in (("full", "full", 16), ("hpass32", "hpass", 32),
                             ("wpass", "wpass", 16), ("full4", "full", 4)):
        c = kv.case(name, b, 1620, **geo)
        assert c.work == kv.prodlike_work(b, **geo, mode=mode, tile=tile)
        assert not c.exact and c.full_function == (mode == "full")
    for g in (2, 4, 8):
        c = kv.case(f"M{g}", b, 1620, **geo)
        assert c.work == kv.combo_work(b, **geo, tile=32) and c.frames == g


def test_shared_memory_is_s2s_for_full():
    """full's block is S2's at N (8 for 4-row strips: 2 blocks an SM);
    hpass keeps no H rows and wpass no B, its ring 2 T rows."""
    geo = (1920, 1080, 224, 224, LANCZOS_AA)
    for tile in pl.PRODLIKE_STRIPS["full"]:
        t = banded.static2_tables(*geo, tile, 8)
        smem = pl.prodlike_smem_bytes("full", tile, t.k_luma, t.k_chroma)
        assert smem == banded.static2_smem_bytes(max(tile, 8), t.k_luma,
                                                 t.k_chroma)
    t16 = banded.static2_tables(*geo, 16, 8)
    kst = t16.k_luma + t16.k_chroma
    chunk = 8 * (16 * 16 + 16) + 4 * (32 * 16 + 16)
    assert pl.prodlike_smem_bytes("hpass", 16, t16.k_luma, t16.k_chroma) == \
        3 * kst * 128 + 2 * kst * 16
    assert pl.prodlike_smem_bytes("wpass", 16, 0, 0) == \
        3 * 32 * 128 + 2 * chunk == 20864
    assert 2 * (pl.prodlike_smem_bytes("full", 16, t16.k_luma,
                                       t16.k_chroma) + 1024) <= 233472


@pytest.mark.parametrize("mode", ["full", "hpass", "wpass"])
def test_64_row_strips_are_refused_before_a_launch(mode):
    """T = 64 (the notebook's main_modes runs full at 64) is refused on
    either device with the wrapper's count unchanged: full's and hpass's
    block needs more shared memory than a block's (S2's layout: 303,488 B
    at 1080p -> 224), wpass runs at 16 and 32 only; so are strip heights
    the mode does not run (full: 4 on nv12_prodlike.cu, S2's on S2's)."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    why = pl.prodlike_refusal(**geo, mode=mode, tile=64)
    if mode == "full":
        assert "303488 B of shared memory" in why
    elif mode == "hpass":
        assert "shared memory" in why
    else:
        assert "strips of 16, 32 rows" in why
    assert pl.PRODLIKE_STRIPS["full"] == (4,) + banded.STATIC2_TILES
    x = torch.zeros((1, 1620, 1920), dtype=torch.uint8)
    before = kv.prod_like.launches
    with pytest.raises(ValueError, match="shared memory" if mode != "wpass"
                       else "16, 32"):
        kv.prod_like(x, **geo, mode=mode, rows_per_block=64)
    bad = {"full": (12, 20), "hpass": (4, 8, 24), "wpass": (8, 48)}[mode]
    for tile in bad:
        with pytest.raises(ValueError, match="run " + mode):
            kv.prod_like(x, **geo, mode=mode, rows_per_block=tile)
    for tile in pl.PRODLIKE_STRIPS[mode]:
        assert pl.prodlike_refusal(**geo, mode=mode, tile=tile) == ""
    assert kv.prod_like.launches == before


def test_multiframe_refuses_what_it_does_not_run():
    """multiframe runs 1, 2, 4 and 8 frames a block at 32-row strips; 16
    or 3 raise before any launch, on the CPU too."""
    x = torch.zeros((16, 216, 256), dtype=torch.uint8)
    geo = dict(src_w=256, src_h=144, dst_w=96, dst_h=64)
    before = kv.multiframe.launches
    with pytest.raises(ValueError, match=r"runs \(1, 2, 4, 8\)"):
        kv.multiframe(x, **geo, gframes=16)
    with pytest.raises(ValueError, match="multiple"):
        kv.multiframe(x, **geo, gframes=3)
    assert kv.multiframe.launches == before
    for g in kv.MULTIFRAME_FRAMES:
        out = kv.multiframe(x, **geo, gframes=g)
        assert out.shape == (16, 3, 64, 96)
    assert kv.multiframe.launches == before


def test_source_instances_signature_and_the_earlier_template_gone():
    """nv12_prodlike.cu compiles exactly PRODLIKE_TILES (N = max(T, 8);
    full at 4 only, S2's strip heights being S2's own instances),
    its launcher's ctypes signature is the labs', S2 includes the shared
    block, and the CUDA-core nv12_variant_kernel / nv12_variant_launch
    are gone from the sources and the signatures."""
    csrc = os.path.join(_cuda_build._PKG_DIR, "csrc")
    src = open(os.path.join(csrc, "nv12_prodlike.cu")).read()
    got = {}
    for m, n, t in re.findall(r"NV12_PRODLIKE\((k\w+), (\d+), (\d+)\)\n",
                              src):
        mode = {"kFull": "full", "kHpass": "hpass", "kWpass": "wpass"}[m]
        assert int(n) == pl.prodlike_n(int(t))
        got.setdefault(mode, []).append(int(t))
    assert {k: tuple(v) for k, v in got.items()} == pl.PRODLIKE_TILES
    assert "nv12_prodlike_launch" in _cuda_build._LAB_SIGNATURES
    assert "csrc/nv12_prodlike.cu" in _cuda_build._LAB_SOURCES
    assert "csrc/static2_passes.cuh" in _cuda_build._HEADERS
    for name in ("nv12_static2.cu", "nv12_prodlike.cu"):
        assert '#include "static2_passes.cuh"' in open(
            os.path.join(csrc, name)).read()
    assert "nv12_variant_launch" not in _cuda_build._LAB_SIGNATURES
    for name in os.listdir(csrc):
        text = open(os.path.join(csrc, name)).read()
        assert "nv12_variant_kernel" not in text, name
        assert "nv12_variant_launch" not in text, name
