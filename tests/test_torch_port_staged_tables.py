"""The host side of lab kernel ``staged`` (vali_tpu_torch/lab/staged.py,
read by csrc/nv12_staged.cu, the Hopper form of the notebook's
``variant_kernel`` B / C / D) on the CPU, at the lab's 1080p -> 224 and at
the card tests' shapes: the operand buffer's layout (every window sample
at one bf16 slot, read back as window^T through MN-major descriptors),
the shared-memory images the card's descriptor test uploads, B's and C's
interleaved chroma W tables against the dense interleaved weights, a
numpy replay of B / C and D through the tables as the kernel's blocks run
them against ``nv12_preprocess_plain``, ``staged_work``'s counts, the
shared memory, and the refusal before any launch. No card and no JAX
needed: test_torch_port_lab_variants.py holds the wrapper's CPU route to
the TPU notebook."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.lab import staged as st
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.banded import core_matrix_order
from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess_plain
from vali_tpu_torch.ops.resize import LANCZOS_AA, round_to

#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(1920, 1080, 224, 224), (162, 90, 50, 20), (130, 62, 34, 30),
              (256, 96, 48, 40), (256, 144, 96, 64), (322, 150, 202, 70)]
#: (variant, tile) of every instance of the kernel
INSTANCES = [("B", 16), ("C", 16), ("D", 16), ("D", 32)]
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vali_tpu_torch", "csrc", "nv12_staged.cu")


def _col_of_m():
    """The chunk column each operand M row holds (operand_m inverted)."""
    cols = np.arange(st.CHUNK)
    out = np.empty_like(cols)
    out[st.operand_m(cols)] = cols
    return out


def _b_as_read(m):
    """[strips, N, K] of B as the kernel's descriptors read it from the
    uploaded core-matrix order (k-steps N * 32 bytes apart, 8-row groups
    256 bytes, k halves 128 bytes)."""
    n_rows, k_cols = m.shape[1:]
    flat = core_matrix_order(m)
    n = np.arange(n_rows)[:, None]
    k = np.arange(k_cols)[None, :]
    idx = ((k // 16) * n_rows * 16 + (n // 8) * 128 + (k % 16 // 8) * 64
           + (n % 8) * 8 + k % 8)
    return flat[:, idx]


@pytest.mark.parametrize("geo", GEOMETRIES)
@pytest.mark.parametrize("tile", [16, 32])
def test_every_window_sample_lands_at_one_bf16_slot(geo, tile):
    """The converter's layout: each (window row, chunk column) of a stage
    has its own 2-byte slot inside a warpgroup's 8 M blocks, a thread's 8
    samples of one row and parity fill one 16-byte core-matrix row, and a
    quarter warp's stores (8 threads: rows k, k + 1 at 4 column groups)
    fall in 8 distinct 16-byte bank groups."""
    t = banded.static2_tables(*geo, LANCZOS_AA, tile, st.STAGED_ALIGN)
    kst = t.k_luma + t.k_chroma
    off = st.operand_offsets(kst)
    assert off.shape == (kst, 64)
    assert len(np.unique(off)) == off.size and (off % 2 == 0).all()
    assert off.min() == 0 and off.max() + 2 <= 8 * st.operand_pitch(kst)
    # the even and the odd columns of 16 of one row: one 16-byte row each
    for k in range(0, kst, 7):
        for p in range(4):
            for par in range(2):
                o = off[k, 16 * p + par:16 * (p + 1):2]
                assert o[0] % 16 == 0 and (np.diff(o) == 2).all()
    # thread i of a warpgroup takes row i // 4, 16 columns 16 (i mod 4):
    # one store of a quarter warp per 16-byte group of the bank width
    for k0 in range(0, kst - 1, 2):
        for par in range(2):
            starts = [off[k0 + i // 4, 16 * (i % 4) + par] for i in range(8)]
            assert len({s % 128 // 16 for s in starts}) == 8


@pytest.mark.parametrize("geo", GEOMETRIES[:3])
def test_descriptor_walk_reads_back_the_window_transposed(geo):
    """Walking each k-step's MN-major descriptor (leading byte offset
    OPERAND_LBO along K, stride byte offset the pitch along M) over the
    converted operand gives window^T: A[m, k] = window[16 j + k, column of
    M row m], for the luma k-steps from byte 0 and the chroma k-steps from
    byte 16 ky."""
    t = banded.static2_tables(*geo, LANCZOS_AA, 16, st.STAGED_ALIGN)
    kst = t.k_luma + t.k_chroma
    rng = np.random.default_rng(kst)
    window = rng.integers(0, 256, (kst, 64), dtype=np.uint8)
    buf = st.convert_stage(window)
    pitch = st.operand_pitch(kst)
    cols = _col_of_m()
    for start_row, nk in ((0, t.k_luma // 16), (t.k_luma, t.k_chroma // 16)):
        for j in range(nk):
            start = (start_row // 8) * st.OPERAND_LBO + 2 * st.OPERAND_LBO * j
            a = st.bf16_values(st.descriptor_read(buf, start, st.OPERAND_LBO,
                                                  pitch))
            want = window[start_row + 16 * j:start_row + 16 * (j + 1)]
            assert np.array_equal(a, want[:, cols].T.astype(np.float32))
    # read as K-major, the same bytes are not window^T
    a = st.bf16_values(st.descriptor_read(buf, 0, st.OPERAND_LBO, pitch,
                                          mn_major=False))
    assert not np.array_equal(a, window[:16, cols].T.astype(np.float32))


@pytest.mark.parametrize("mn_major", [True, False])
@pytest.mark.parametrize("lbo,sbo", [(128, 2064), (1024, 128), (256, 512)])
def test_operand_image_inverts_the_descriptor_read(mn_major, lbo, sbo):
    """The card's descriptor test uploads operand_image(a) and reads it
    with the same offsets: read back, it is ``a``, and it fits the probe's
    16 KB."""
    a = np.random.default_rng(lbo + sbo).integers(0, 1 << 16, (64, 16),
                                                  dtype=np.uint16)
    img = st.operand_image(a, lbo, sbo, mn_major)
    assert img.size % 16 == 0 and img.size <= 16 * 1024
    assert np.array_equal(st.descriptor_read(img, 0, lbo, sbo, mn_major), a)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_interleaved_w_tables_are_the_dense_interleaved_weights(geo):
    """B's and C's W tables: per output tile and chunk, the luma k-steps
    are S2's, and the U and V k-steps read back (fragment order undone)
    are the TPU's interleaved chroma weights wcw_i (U output o at column
    o, V at DW + o; interleaved source column 2 j + plane) at the chunk's
    64 interleaved columns, zero past the row and the tile."""
    src_w, src_h, dst_w, dst_h = geo
    dw = banded.dense_weights(*geo, LANCZOS_AA, "420")
    wc = round_to(dw.chroma_w, torch.bfloat16).numpy()     # [DW, W / 2]
    wcw_i = np.zeros((src_w, 2 * dst_w), np.float32)
    wcw_i[0::2, :dst_w] = wc.T
    wcw_i[1::2, dst_w:] = wc.T
    s2 = banded.static2_w_tables(*geo, LANCZOS_AA)
    wt = st.interleaved_w_tables(*geo, LANCZOS_AA)
    assert np.array_equal(wt.heads, s2.heads)
    assert wt.frags.shape == (s2.frags.shape[0], 12, 128, 8)
    assert np.array_equal(wt.frags[:, :4], s2.frags[:, :4])
    for tile_i, (first, x0, chunks, _) in enumerate(wt.heads):
        oc = 64 * tile_i + np.arange(64)
        for j in range(chunks):
            au = st.fragment_matrix(wt.frags[first + j, 4:8])   # [64, 64]
            av = st.fragment_matrix(wt.frags[first + j, 8:12])
            c0 = x0 + 64 * j
            n = max(0, min(64, src_w - c0))
            for plane, a in ((0, au), (1, av)):
                want = np.zeros((64, 64), np.float32)
                live = oc < dst_w
                want[live, :n] = wcw_i[c0:c0 + n,
                                       plane * dst_w + oc[live]].T
                assert np.array_equal(a, want), (tile_i, j, plane)


def _replay(nv12, geo, variant, tile):
    """Both passes of the staged kernel in numpy, block by block and stage
    by stage as it runs them: the stage's window rows as TMA lands them
    (zero past the NV12 rows and the row), each warpgroup's chunk through
    the converter's layout and its descriptors, fp32 H sums rounded to
    bf16, the W pass from the uploaded fragments (B, C: U and V weights
    over the interleaved H rows; D: per-pixel weights over the
    deinterleaved rows), then the product's tail. Returns the output and
    the FLOPs its products issue."""
    src_w, src_h, dst_w, dst_h = geo
    b = nv12.shape[0]
    t = banded.static2_tables(*geo, LANCZOS_AA, tile, st.STAGED_ALIGN)
    wt = (banded.static2_w_tables(*geo, LANCZOS_AA) if variant == "D"
          else st.interleaved_w_tables(*geo, LANCZOS_AA))
    by, bc = _b_as_read(t.luma), _b_as_read(t.chroma)
    ky, kc = t.k_luma, t.k_chroma
    kst = ky + kc
    pitch = st.operand_pitch(kst)
    m_of_col = st.operand_m(np.arange(st.CHUNK))
    nv12_rows = src_h * 3 // 2
    strips = by.shape[0]
    sums = np.zeros((3, b, strips * tile, dst_w), np.float32)
    w_steps = 4 + (4 if variant == "D" else 8)
    flops = 0
    for s in range(strips):
        rows = np.concatenate([t.starts[s, 0] + np.arange(ky),
                               src_h + t.starts[s, 1] + np.arange(kc)])
        for tile_i, (first, x0, chunks, _) in enumerate(wt.heads):
            acc = np.zeros((3, b, 64, tile), np.float32)
            for stage in range(chunks // 2):
                c0 = x0 + 128 * stage
                land = np.zeros((b, kst, 128), np.uint8)
                n = max(0, min(128, src_w - c0))
                live = rows < nv12_rows
                land[:, live, :n] = nv12[:, rows[live], c0:c0 + n]
                for wg in range(2):
                    chunk = first + 2 * stage + wg
                    a = np.stack([np.concatenate([st.bf16_values(
                        st.descriptor_read(st.convert_stage(
                            land[f, :, 64 * wg:64 * (wg + 1)]),
                            2 * st.OPERAND_LBO * j, st.OPERAND_LBO, pitch))
                        for j in range(kst // 16)], axis=1)
                        for f in range(b)])                 # [b, 64, kst]
                    h = []
                    for bm, k0, k in ((by, 0, ky), (bc, ky, kc)):
                        hm = a[:, :, k0:k0 + k] @ bm[s].T   # [b, 64, T]
                        hm = torch.from_numpy(hm).to(
                            torch.bfloat16).float().numpy()
                        h.append(hm[:, m_of_col].transpose(0, 2, 1))
                    hy, hc = h                              # [b, T, 64]
                    f = wt.frags[chunk]
                    acc[0] += st.fragment_matrix(f[:4]) @ hy.transpose(
                        0, 2, 1)
                    if variant == "D":
                        ac = st.fragment_matrix(f[4:6])     # [64, 32]
                        acc[1] += ac @ hc[..., 0::2].transpose(0, 2, 1)
                        acc[2] += ac @ hc[..., 1::2].transpose(0, 2, 1)
                    else:
                        acc[1] += st.fragment_matrix(f[4:8]) @ \
                            hc.transpose(0, 2, 1)
                        acc[2] += st.fragment_matrix(f[8:12]) @ \
                            hc.transpose(0, 2, 1)
                    flops += 2 * 64 * 16 * tile * (kst // 16 + w_steps)
            p0 = 64 * tile_i
            n = min(64, dst_w - p0)
            sums[:, :, s * tile:(s + 1) * tile, p0:p0 + n] = \
                acc.transpose(0, 1, 3, 2)[..., :n]
    eye = torch.eye(dst_w)
    tail = banded.tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0,
                              torch.uint8, None)
    y, u, v = (torch.from_numpy(x[:, :dst_h]) for x in sums)
    return banded.w_pass_tail_plain(y, u, v, eye, eye, tail,
                                    torch.uint8).numpy(), flops


@pytest.mark.parametrize("variant,tile", [("B", 16), ("D", 16), ("D", 32)])
@pytest.mark.parametrize("geo,batch", [(GEOMETRIES[0], 1),
                                       (GEOMETRIES[1], 3),
                                       (GEOMETRIES[2], 2),
                                       (GEOMETRIES[3], 2),
                                       (GEOMETRIES[4], 2)])
def test_replay_within_the_envelope_of_the_plain_version(geo, batch, variant,
                                                         tile):
    """The numpy replay of the tables (B's stands for C's: the same values
    in the same products) is within 1 LSB of nv12_preprocess_plain on
    fewer than 1e-3 of the samples (fp32 sums in another order), and its
    products issue the FLOPs staged_work counts, with the product's
    bytes."""
    src_w, src_h, dst_w, dst_h = geo
    x = np.random.default_rng(src_w + tile).integers(
        0, 256, (batch, src_h * 3 // 2, src_w), dtype=np.uint8)
    got, flops = _replay(x, geo, variant, tile)
    want = nv12_preprocess_plain(torch.from_numpy(x), src_w=src_w,
                                 src_h=src_h, dst_w=dst_w,
                                 dst_h=dst_h).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    from vali_tpu_torch.lab.timing import CSC_OPS
    nbytes, ops = kv.staged_work(batch, *geo, variant=variant, tile=tile)
    assert ops == batch * (flops + CSC_OPS * dst_h * dst_w)
    assert nbytes == batch * (src_h * 3 // 2 * src_w + 3 * dst_h * dst_w)


def test_staged_work_at_1080p():
    """At 64 x 1080p -> 224: D at 16 rows issues S2 t16a8's FLOPs, B and C
    each more by 4 chroma W k-steps at N = 16 a chunk, D at 32 rows more
    than at 16; the lab's B, C, D cases report them."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    d16 = kv.staged_work(64, **geo, variant="D")
    assert d16 == kv.static2_work(64, **geo, tile=16, align=8)
    assert d16 == (208699392, 20149764096)
    b16 = kv.staged_work(64, **geo, variant="B")
    chunks = int(banded.static2_w_tables(1920, 1080, 224, 224,
                                         LANCZOS_AA).heads[:, 2].sum())
    assert b16[1] - d16[1] == 64 * 14 * chunks * 2 * 64 * 16 * 16 * 4
    assert kv.staged_work(64, **geo, variant="C") == b16
    assert kv.staged_work(64, **geo, variant="D", tile=32)[1] > d16[1]
    for name in kv.VARIANTS:
        assert kv.case(name, 64, 1620, **geo).work == \
            kv.staged_work(64, **geo, variant=name)
        assert not kv.case(name, 64, 1620, **geo).exact


@pytest.mark.parametrize("variant,tile", INSTANCES)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_refusal_admits_the_lab_and_test_shapes(geo, variant, tile):
    """Every instance launches at the lab's size and the card tests'
    shapes, two blocks an SM at 16-row strips and one at 32."""
    assert st.staged_refusal(*geo, LANCZOS_AA, variant, tile) == ""
    t = banded.static2_tables(*geo, LANCZOS_AA, tile, st.STAGED_ALIGN)
    assert st.blocks_per_sm(variant, tile, t.k_luma, t.k_chroma) == \
        (2 if tile == 16 else 1)


@pytest.mark.parametrize("geo,variant,tile,why", [
    ((1920, 1080, 224, 224), "B", 32, "strips of 16 rows"),
    ((1920, 1080, 224, 224), "C", 24, "strips of 16 rows"),
    ((1920, 1080, 224, 224), "D", 48, "strips of 16 or 32 rows"),
    ((1920, 1080, 224, 224), "E", 16, "variant must be one of"),
    ((3840, 2160, 224, 32), "B", 16, "shared memory"),
    ((3840, 2160, 224, 32), "D", 16, "shared memory"),
])
def test_refusal_refuses_before_any_launch(geo, variant, tile, why):
    """A (variant, strip) the kernel is not built for, or windows whose
    landing ring and operand buffers pass a block's shared memory, is
    refused; the wrapper raises for the last on the CPU too, with its
    launch count unchanged."""
    assert re.search(why, st.staged_refusal(*geo, LANCZOS_AA, variant, tile))
    if why == "shared memory":
        sw, sh, dw, dh = geo
        x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8)
        before = kv.variant_kernel.launches
        with pytest.raises(ValueError, match=why):
            kv.variant_kernel(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh,
                              variant=variant)
        assert kv.variant_kernel.launches == before


def test_smem_bytes_match_the_kernel_layout():
    """The block's shared memory as the kernel lays it out: two landing
    slots (or the traded W sums), two operand buffers of 8 M blocks, B_y
    and B_c, two warpgroups' H rows of a chunk, two barriers; at 1080p ->
    224 about 102 KB at 16-row strips, two blocks an SM."""
    t = banded.static2_tables(1920, 1080, 224, 224, LANCZOS_AA, 16, 8)
    assert (t.k_luma, t.k_chroma) == (112, 64)
    kst = 176
    gy, gc = 16 * 16 + 16, 32 * 16 + 16
    base = 2 * kst * 128 + 16 * (16 * kst + 16) + 2 * kst * 16 + 16
    assert st.staged_smem_bytes("D", 16, 112, 64) == \
        base + 2 * (8 * gy + 4 * gc) == 104592
    assert st.staged_smem_bytes("B", 16, 112, 64) == \
        base + 2 * 16 * gy == 104720
    assert st.staged_smem_bytes("C", 16, 112, 64) == 104720
    # a tiny window: the traded sums (4 (T / 2 + T) 128 bytes) set the ring
    assert st.staged_smem_bytes("D", 32, 16, 16) == (
        4 * 48 * 128 + 16 * (16 * 32 + 16) + 2 * 32 * 32
        + 2 * (8 * 528 + 4 * 1040) + 16)


def test_source_constants_match_the_host_side():
    """The .cu's landing slots, K-block stride, operand pitch, box rows and
    instances are the ones lab/staged.py assumes."""
    text = open(SOURCE).read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             text).group(1))
    assert const("kSlots") == st.STAGED_SLOTS
    assert const("kLbo") == st.OPERAND_LBO
    assert const("kBox") == 16
    assert "return 16 * kst + 16;" in text
    assert st.operand_pitch(176) == 16 * 176 + 16
    found = set(re.findall(r"tile == (\d+) && variant == k([BCD])", text))
    assert found == {(str(t), v) for v, t in INSTANCES}
    assert set(st.STAGED_VARIANTS) == set(kv.VARIANTS) == {"B", "C", "D"}
    assert re.search(r"enum Variant : int \{ kB = 0, kC = 1, kD = 2 \}",
                     text)


@pytest.mark.parametrize("variant", ["B", "D"])
def test_device_tables_are_cached_and_in_core_matrix_order(variant):
    """The launch arguments, uploaded once a geometry: B_y then B_c of
    each strip in core-matrix order, S2's starts and heads, and the W
    fragments (12 k-steps a chunk for B and C, S2's 6 for D)."""
    geo = (256, 144, 96, 64)
    cpu = torch.device("cpu")
    args, keep = st.staged_device(*geo, variant, 16, cpu)
    assert st.staged_device(*geo, variant, 16, cpu)[1] is keep
    t = banded.static2_tables(*geo, LANCZOS_AA, 16, 8)
    b = np.concatenate([core_matrix_order(t.luma),
                        core_matrix_order(t.chroma)], axis=1)
    assert torch.equal(keep[0].float(), torch.from_numpy(b))
    assert np.array_equal(keep[1].numpy(), t.starts)
    assert args[2:4] == (t.k_luma, t.k_chroma)
    assert keep[3].shape[1] == (6 if variant == "D" else 12)
    assert keep[0].dtype == keep[3].dtype == torch.bfloat16
