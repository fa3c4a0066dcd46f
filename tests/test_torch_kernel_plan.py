"""Launch plans of the port's CUDA kernels, checked on the CPU.

``fused_linear.plan`` and ``flash_attention.variant`` are pure functions
of shapes, dtypes and alignment: which kernel variant a call takes, its
tiles, its pipeline depth and its cluster (the K split).  Here every
served shape of the three models must take a variant built for it (never
the WMMA kernels kept for operands TMA cannot take), fill the card where
its size allows, fit a CTA's shared memory, and split K exactly.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_linear as FL

SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448  # bytes of shared memory a CTA may use (227 KB)

#: (model, M, K, N): every fused-linear width of each model at its served
#: rows — forge-125m at decode (paged rungs 1, 2, 4), the paged prefill
#: cells (32 .. 256 rows) and the full-sequence forward (4 x 1024);
#: recurrentgemma-2b and xlstm-350m at decode (4), the B4 x S32 prefill
#: cell (128) and apply (2 x 1024)
SERVED = ([("forge-125m", M, K, N) for M in (1, 2, 4, 32, 64, 128, 256, 4096)
           for K, N in ((768, 3072), (3072, 768), (768, 768))]
          + [("recurrentgemma-2b", M, K, N) for M in (4, 128, 2048)
             for K, N in ((2560, 2560), (2560, 7680), (7680, 2560))]
          + [("xlstm-350m", M, K, N) for M in (4, 128, 2048)
             for K, N in ((1024, 2048), (2048, 1024), (1024, 1024), (2048, 2048),
                          (1024, 4096))])


def _most_ctas(variant, M, K, N, esize):
    """The most CTAs the variant's tiles can give the shape with a
    cluster of at most 8 (one K unit a rank at least): where this reaches
    the SM count, the plan must too."""
    if variant == "gemv":
        return -(-N // (4 * 16 // esize)) * max(1, min(8, K // 64))
    return -(-M // (64 if M <= 64 else 128)) * -(-N // 128) * min(8, -(-K // 64))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("model,M,K,N", SERVED,
                         ids=[f"{m}-M{M}-K{K}-N{N}" for m, M, K, N in SERVED])
def test_served_shape_plan(model, M, K, N, dtype):
    p = FL.plan(M, N, K, dtype, True)
    variant, bm, bn, stages, cluster = p
    if dtype == torch.bfloat16:
        assert variant == ("gemv" if M <= 16 else "wgmma"), p
    else:
        assert variant == ("gemv" if M <= 16 else "fma"), p
    assert cluster in (1, 2, 4, 8), p
    assert FL.smem_bytes(p, dtype) <= MAX_SMEM, p
    if variant == "gemv":
        assert bm >= M and bm & (bm - 1) == 0 and bm <= 16, p
    if variant in ("gemv", "wgmma"):
        esize = 2 if dtype == torch.bfloat16 else 4
        if _most_ctas(variant, M, K, N, esize) >= SMS:
            assert FL.ctas(p, M, N) >= SMS, (p, FL.ctas(p, M, N))
    # the ranks' K ranges tile [0, K) in rank order, none empty
    ranges = FL.k_ranges(p, K)
    assert len(ranges) == cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(cluster - 1))


@pytest.mark.parametrize("M,K,N", [(7, 33, 45), (40, 33, 45), (4, 768, 3072), (128, 2560, 2560),
                                   (4096, 768, 768), (1, 100, 10)])
def test_unaligned_operands_take_wmma_in_bf16(M, K, N):
    assert FL.plan(M, N, K, torch.bfloat16, False)[0] == "wmma"
    assert FL.plan(M, N, K, torch.float32, False)[0] == "fma"


@pytest.mark.parametrize("M,K,N,aligned", [(7, 33, 45, False), (40, 33, 45, False),
                                           (4, 768, 3072, True), (300, 768, 768, True)])
def test_alignment_of_operands(M, K, N, aligned):
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(K, N, dtype=torch.bfloat16)
    assert FL.is_aligned(x, w) == aligned


def test_view_at_two_byte_offset_is_unaligned():
    flat = torch.zeros(4 * 768 + 8, dtype=torch.bfloat16)
    x = flat[1:1 + 4 * 768].view(4, 768)
    w = torch.zeros(768, 768, dtype=torch.bfloat16)
    assert x.is_contiguous() and not FL.is_aligned(x, w)
    assert FL.is_aligned(flat[8:].view(4, 768), w)  # 16 bytes on: aligned again


@pytest.mark.parametrize("K", [64, 200, 776, 1000, 2560, 7680])
@pytest.mark.parametrize("variant", ["gemv", "wgmma"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_k_ranges_cover_ragged_k(K, variant, cluster):
    ranges = FL.k_ranges((variant, 128, 128, 4, cluster), K)
    covered = [k for a, b in ranges for k in range(a, b)]
    assert covered == list(range(K))
    unit = 8 if variant == "gemv" else 64
    assert all(a % unit == 0 for a, _ in ranges)


@pytest.mark.parametrize("M", [1, 3, 16, 17, 64, 65, 300])
def test_variant_boundaries(M):
    variant, bm = FL.plan(M, 1024, 1024, torch.bfloat16, True)[:2]
    if M <= 16:
        assert variant == "gemv" and bm == 1 << (M - 1).bit_length()
    else:
        assert variant == "wgmma" and bm == (64 if M <= 64 else 128)


def test_plan_is_cached():
    assert FL.plan(4, 768, 768, torch.bfloat16, True) is FL.plan(4, 768, 768, torch.bfloat16, True)


def test_gemv_splits_only_as_far_as_the_rows_allow():
    # K = 96: one 64-row unit a rank at most, so no split
    p = FL.plan(4, 64, 96, torch.bfloat16, True)
    assert p[0] == "gemv" and p[4] == 1
    # a wide product fills the card without a split
    p = FL.plan(4, 65536, 1024, torch.bfloat16, True)
    assert p[4] == 1 and FL.ctas(p, 4, 65536) >= SMS


def _qkv(B=2, H=12, KVH=4, Sq=64, Sk=64, D=64, dtype=torch.bfloat16):
    return (torch.zeros(B, H, Sq, D, dtype=dtype), torch.zeros(B, KVH, Sk, D, dtype=dtype),
            torch.zeros(B, KVH, Sk, D, dtype=dtype))


@pytest.mark.parametrize("D", [16, 32, 64])
def test_flash_contiguous_bf16_takes_the_warpgroup_kernel(D):
    assert FA.variant(*_qkv(D=D)) == "wgmma"


def test_flash_transposed_projections_take_the_warpgroup_kernel():
    # the model hands over (B, S, H, D) projections transposed to (B, H, S, D)
    x = torch.zeros(4, 1024, 12, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert not x.is_contiguous() and FA.tma_legal(x)
    assert FA.variant(x, x, x) == "wgmma"


def test_flash_views_tma_cannot_take():
    q, k, v = _qkv()
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)  # base on a 2-byte boundary
    assert FA.variant(shifted, k, v) == "wmma"
    wide = torch.zeros(2, 12, 64, 68, dtype=torch.bfloat16)[..., :64]  # rows of 136 bytes
    assert not FA.tma_legal(wide) and FA.variant(wide, k, v) == "wmma"
    assert FA.variant(q, k[:, :, :0], v[:, :, :0]) == "wmma"  # no key: nothing for TMA
    assert FA.variant(*_qkv(dtype=torch.float32)) == "fma"


def test_flash_size_one_dims_ignore_their_strides():
    q = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16).as_strided((1, 1, 64, 64),
                                                                   (3, 5, 64, 1))
    assert FA.tma_legal(q)


def test_launch_count_by_variant():
    c = _build.LaunchCount()
    c.count("gemv")
    c.count("wgmma")
    c.count("gemv")
    c.count()
    assert c.n == 4 and c.variants == {"gemv": 2, "wgmma": 1}
    c.reset()
    assert c.n == 0 and c.variants == {}
