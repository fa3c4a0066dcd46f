"""Launch plans of the port's CUDA kernels, checked on the CPU.

``fused_linear.plan``, ``flash_attention.variant``,
``paged_attention.plan`` and ``rg_lru.plan`` are pure functions of
shapes, dtypes and alignment: which kernel variant a call takes, its
tiles, its pipeline depth, its cluster (the K split), the blocks that
share a row's pages, the chunks of T.  Here every served shape of the
three models must take a variant built for it (never the WMMA kernels
kept for operands TMA cannot take), fill the card where its size allows,
fit a CTA's shared memory, and split K, pages and T exactly.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_linear as FL
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rg_lru as RG

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


@pytest.mark.parametrize("D", [16, 32, 64, 96, 112, 128])
def test_flash_contiguous_bf16_takes_the_warpgroup_kernel(D):
    assert FA.variant(*_qkv(D=D)) == "wgmma"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [16, 32, 64, 96, 112, 128, 256])
def test_flash_every_head_dim_has_a_variant_that_fits(D, dtype):
    """Every head dim the JAX kernel serves (64, 96, 112, 128, 256) and
    the smoke configs' 16 and 32 pick a kernel that is built for it and
    fits a CTA's shared memory; bf16 takes the warpgroup kernel up to 128
    and WMMA at 256 (its O accumulator would not fit the registers)."""
    assert D in FA.HEAD_DIMS
    kind = FA.variant(*_qkv(D=D, dtype=dtype))
    want = "fma" if dtype == torch.float32 else "wgmma" if D <= 128 else "wmma"
    assert kind == want
    assert 0 < FA.smem_bytes(kind, D) <= MAX_SMEM
    if dtype == torch.bfloat16:  # the views TMA cannot take: WMMA, which fits too
        assert 0 < FA.smem_bytes("wmma", D) <= MAX_SMEM


def test_flash_has_no_warpgroup_kernel_at_256():
    with pytest.raises(ValueError):
        FA.smem_bytes("wgmma", 256)
    with pytest.raises(ValueError):
        FA.smem_bytes("fma", 48)


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


#: paged decode shapes (B, H, KVH, D, ps, MP, window): forge-125m's served
#: rungs (B 1, 2, 4; 16 pages of 16 a row), the long-context row (B 8,
#: 128 live pages), GQA at D = 128 (groups of 4, and qwen2.5-14b's of 5),
#: the new head dims, a window
PAGED_SHAPES = [(1, 12, 12, 64, 16, 16, None), (2, 12, 12, 64, 16, 16, None),
                (4, 12, 12, 64, 16, 16, None), (8, 12, 12, 64, 16, 128, None),
                (4, 32, 8, 128, 16, 128, None), (4, 12, 12, 64, 16, 16, 20),
                (2, 8, 2, 96, 16, 6, None), (2, 8, 2, 112, 16, 6, 40),
                (3, 4, 1, 256, 16, 6, None), (64, 32, 8, 128, 16, 256, None),
                (1, 1, 1, 8, 8, 4, None), (2, 10, 1, 256, 16, 128, 2048),
                (4, 40, 8, 128, 16, 16, None), (4, 40, 8, 128, 16, 128, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,KVH,D,ps,MP,window", PAGED_SHAPES,
                         ids=[f"B{s[0]}-H{s[1]}-KVH{s[2]}-D{s[3]}-MP{s[5]}-w{s[6]}"
                              for s in PAGED_SHAPES])
def test_paged_plan(B, H, KVH, D, ps, MP, window, dtype):
    """The split fills the card where the live pages allow, never splits
    past them, loads at most a split's share a chunk, and fits shared
    memory."""
    splits, chunk = PA.plan(B, H, KVH, D, ps, MP, window, dtype)
    live = PA.max_live_pages(MP, ps, window)
    assert 1 <= splits <= live
    if B * KVH * live >= SMS:
        assert B * KVH * splits >= SMS
    assert 1 <= chunk <= -(-live // splits) and chunk * ps <= max(ps, PA.CHUNK_KEYS)
    assert PA.smem_bytes(H, KVH, D, ps, chunk, dtype) <= MAX_SMEM


@pytest.mark.parametrize("MP,ps,window,want", [(16, 16, None, 16), (16, 16, 1, 1),
                                               (16, 16, 16, 2), (16, 16, 17, 2),
                                               (16, 16, 20, 3), (128, 16, 2048, 128),
                                               (4, 8, 100, 4)])
def test_paged_live_pages(MP, ps, window, want):
    """The most pages a window of keys can touch: a brute-force count."""
    assert PA.max_live_pages(MP, ps, window) == want
    if window is not None:
        worst = max(min(p // ps, MP - 1) - max(0, p - window + 1) // ps + 1
                    for p in range(MP * ps) if max(0, p - window + 1) // ps <= MP - 1)
        assert worst == want


def test_paged_plan_groups_of_five():
    """qwen2.5-14b decodes 40 query heads on 8 KV heads: one block scores
    a group of 5 heads as a quad and a one-head tail (csrc: ``hq =
    min(4, G - g0)``).  The plan at the served table (16 pages a row) and
    at 128 live pages, and the shared memory of G = 5 from the csrc
    layout: fp32 q and accumulators (2 G D), the chunk's scores and m / l
    / alpha (G keys + 3 G, to a multiple of 4), the slice sums (4 x
    threads), then two stages of K and V rows."""
    G, D, ps = 40 // 8, 128, 16
    assert [min(4, G - g0) for g0 in range(0, G, 4)] == [4, 1]
    assert PA.plan(4, 40, 8, D, ps, 16, None, torch.bfloat16) == (16, 1)
    assert PA.plan(4, 40, 8, D, ps, 128, None, torch.bfloat16) == (20, 2)
    assert PA.plan(4, 40, 8, D, ps, 128, None, torch.float32) == (20, 1)
    for chunk, esize, dtype in ((1, 2, torch.bfloat16), (2, 2, torch.bfloat16),
                                (1, 4, torch.float32)):
        keys = chunk * ps
        words = 2 * G * D + ((G * keys + 3 * G + 3) & ~3) + 4 * PA.THREADS
        assert PA.smem_bytes(40, 8, D, ps, chunk, dtype) == \
            words * 4 + PA.STAGES * 2 * keys * D * esize
    assert 4 * 8 * 20 >= SMS  # 128 live pages: the grid fills the card


def test_paged_plan_is_cached():
    assert (PA.plan(4, 12, 12, 64, 16, 16, None, torch.bfloat16)
            is PA.plan(4, 12, 12, 64, 16, 16, None, torch.bfloat16))


#: (B, T, D): recurrentgemma-2b's served prefill cells, its apply, the
#: ragged card cases, long and single-step scans
RG_PLAN_SHAPES = [(4, 32, 2560), (4, 64, 2560), (2, 1024, 2560), (3, 37, 100),
                  (2, 100, 300), (1, 1, 2560), (1, 8192, 2560), (16, 32, 2560), (4, 65, 2560)]


@pytest.mark.parametrize("B,T,D", RG_PLAN_SHAPES, ids=[f"B{b}-T{t}-D{d}" for b, t, d in
                                                        RG_PLAN_SHAPES])
def test_rg_lru_plan(B, T, D):
    """Chunks tile T exactly (none empty), hold at most 64 steps (a
    thread's registers), never split past T, and bring the grid to the SM
    count where chunks of 32 steps allow."""
    chunks, steps = RG.plan(B, T, D)
    assert 1 <= chunks <= T and 1 <= steps <= RG.MAX_STEPS
    assert (chunks - 1) * steps < T <= chunks * steps
    tiles = -(-D // RG.CHANNELS)
    if B * tiles * -(-T // RG.MIN_STEPS) >= SMS:
        assert B * tiles * chunks >= SMS
    if T <= RG.MIN_STEPS:
        assert chunks == 1  # a short scan runs the sequential chain alone


def test_rg_lru_plan_at_the_served_shapes():
    assert RG.plan(4, 32, 2560) == (1, 32)  # the B4 x S32 prefill cell: one chunk
    chunks, steps = RG.plan(2, 1024, 2560)  # apply: T-parallel
    assert chunks > 1 and 2 * 20 * chunks >= SMS
