"""The port on the card: CUDA kernels against their plain versions, and
the smoke models, servers and slot schedulers going through them.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_linear as FL
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rg_lru as RG
from repro_torch.kernels import rms_norm as RN
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.models import get_model

from torch_port_support import (  # noqa: F401
    TOL_BF16,
    TOL_F32,
    cuda_device,
    paged_workload,
)

ACTS = [None, "relu", "silu", "gelu", "gelu_exact", "tanh"]
#: bf16's unit roundoff: the kernel and the plain version each round
#: every p_j*v_j term and the output once, so a bf16 flash result is held
#: within 3u*(sum_j p_j|v_j| + |out|) of its plain version
BF16_U = 2.0 ** -8


def _qkv(seed, B, H, KVH, Sq, Sk, D, dtype=np.float32):
    """q and k of std 1.5 give scores of std 2.25 after the 1/sqrt(D)
    scale: a peaky softmax and O(1) output rows, so an error in the
    online-softmax rescale is far above the tolerance."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Sq, D)) * 1.5).astype(dtype)
    k = (rng.standard_normal((B, KVH, Sk, D)) * 1.5).astype(dtype)
    v = rng.standard_normal((B, KVH, Sk, D)).astype(dtype)
    return q, k, v


def _assert_flash_bf16(got, q, k, v, scale, causal):
    """A bf16 flash result within the kernel tolerance of its plain version
    and within 3u*(sum_j p_j|v_j| + |out|) of it, element by element."""
    want = FA.flash_attention_plain(q, k, v, scale=scale, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    mass = FA.flash_attention_plain(q, k, v.abs(), scale=scale, causal=causal)
    err = (got.float() - want.float()).abs()
    bound = 3 * BF16_U * (mass.float() + want.float().abs())
    assert bool((err <= bound).all()), (err / bound).max()


@pytest.mark.cuda
class TestKernelsOnCard:
    """CUDA kernels against their plain versions (tolerances of the JAX
    package's kernel tests)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("M,K,N", [(4, 768, 3072), (4, 3072, 768), (300, 768, 768),
                                       (7, 33, 45), (40, 33, 45), (2, 768, 3072),
                                       (32, 3072, 768), (64, 768, 768), (256, 768, 3072)])
    @pytest.mark.parametrize("act", ACTS)
    def test_fused_linear(self, cuda_device, dtype, M, K, N, act):
        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = (torch.randn(M, K, generator=g, device=cuda_device) * 0.5).to(dtype)
        w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).to(dtype)
        b = torch.randn(N, generator=g, device=cuda_device).to(dtype)
        got = FL.fused_linear_cuda(x, w, b, act=act)
        want = FL.fused_linear_plain(x, w, b, act=act)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("B,H,KVH,Sq,Sk,D", [(2, 12, 12, 256, 256, 64),
                                                 (2, 12, 4, 100, 100, 64),
                                                 (1, 4, 4, 64, 200, 32),
                                                 (1, 4, 2, 33, 33, 16),
                                                 (1, 2, 2, 1, 70, 64)])
    def test_flash(self, cuda_device, dtype, causal, B, H, KVH, Sq, Sk, D):
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(11, B, H, KVH, Sq, Sk, D))
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=causal)
        want = FA.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=causal)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if dtype == torch.bfloat16:
            mass = FA.flash_attention_plain(q, k, v.abs(), scale=D ** -0.5, causal=causal)
            err = (got.float() - want.float()).abs()
            bound = 3 * BF16_U * (mass.float() + want.float().abs())
            assert bool((err <= bound).all()), (err / bound).max()

    @pytest.mark.parametrize("M,K,N,variant", [
        (16, 1024, 1024, "gemv"), (17, 1024, 1024, "wgmma"),  # the gemv / wgmma boundary
        (64, 1024, 1024, "wgmma"), (65, 1024, 1024, "wgmma"),  # 64- / 128-row tiles
        (300, 768, 768, "wgmma"), (4100, 256, 384, "wgmma"),  # ragged row tiles
        (128, 1000, 768, "wgmma"), (200, 512, 200, "wgmma"),  # K % 64, N % 128 ragged
        (4, 776, 200, "gemv"), (1, 1000, 72, "gemv"),  # ragged K and N at decode
        (128, 2560, 2560, "wgmma"), (4, 768, 768, "gemv")])  # clusters of 8
    @pytest.mark.parametrize("act", [None, "gelu", "silu"])
    def test_fused_linear_variants(self, cuda_device, M, K, N, variant, act):
        g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
        x = (torch.randn(M, K, generator=g, device=cuda_device) * 0.5).bfloat16()
        w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).bfloat16()
        b = torch.randn(N, generator=g, device=cuda_device).bfloat16()
        p = FL.plan(M, N, K, torch.bfloat16, True)
        assert p[0] == variant
        if (M, K, N) in ((128, 2560, 2560), (4, 768, 768)):
            assert p[4] == 8  # the largest split
        FL.LAUNCHES.reset()
        got = FL.fused_linear_cuda(x, w, b, act=act)
        torch.cuda.synchronize()
        assert FL.LAUNCHES.variants == {variant: 1}
        want = FL.fused_linear_plain(x, w, b, act=act)
        torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)

    @pytest.mark.parametrize("plan", [("wgmma", 128, 128, 4, 8), ("wgmma", 64, 128, 3, 8),
                                      ("wgmma", 128, 128, 2, 1), ("gemv", 16, 32, 8, 8)])
    def test_fused_linear_plans_beyond_the_planner(self, cuda_device, plan):
        """The entry point runs every plan it accepts, not only those the
        planner picks today: clusters of 8 for wgmma, a shallow ring."""
        g = torch.Generator(device=cuda_device).manual_seed(7)
        M, K, N = (12, 1024, 520) if plan[0] == "gemv" else (100, 1024, 520)
        x = (torch.randn(M, K, generator=g, device=cuda_device) * 0.5).bfloat16()
        w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).bfloat16()
        b = torch.randn(N, generator=g, device=cuda_device).bfloat16()
        y = torch.empty(M, N, dtype=torch.bfloat16, device=cuda_device)
        variant, bm, bn, stages, cluster = plan
        rc = FL._lib().forge_fused_linear(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K,
            FL.DTYPE_CODES[torch.bfloat16], FL.ACT_CODES["gelu"], FL.VARIANT_CODES[variant],
            bm, bn, stages, cluster, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.testing.assert_close(y.float(), FL.fused_linear_plain(x, w, b, act="gelu").float(),
                                   **TOL_BF16)

    def test_refused_plans_raise(self, cuda_device):
        x = torch.ones(4, 64, dtype=torch.bfloat16, device=cuda_device)
        w = torch.ones(64, 64, dtype=torch.bfloat16, device=cuda_device)
        y = torch.empty(4, 64, dtype=torch.bfloat16, device=cuda_device)
        for plan in (("wgmma", 96, 128, 4, 1), ("gemv", 2, 64, 8, 1), ("wgmma", 64, 128, 4, 3)):
            variant, bm, bn, stages, cluster = plan
            assert FL._lib().forge_fused_linear(
                x.data_ptr(), w.data_ptr(), None, y.data_ptr(), 4, 64, 64,
                FL.DTYPE_CODES[torch.bfloat16], 0, FL.VARIANT_CODES[variant], bm, bn, stages,
                cluster, torch.cuda.current_stream().cuda_stream) != 0

    def test_misaligned_x_takes_wmma(self, cuda_device):
        g = torch.Generator(device=cuda_device).manual_seed(1)
        flat = (torch.randn(4 * 768 + 8, generator=g, device=cuda_device) * 0.5).bfloat16()
        x = flat[1:1 + 4 * 768].view(4, 768)  # contiguous, on a 2-byte boundary
        w = (torch.randn(768, 768, generator=g, device=cuda_device) / 768 ** 0.5).bfloat16()
        b = torch.randn(768, generator=g, device=cuda_device).bfloat16()
        FL.LAUNCHES.reset()
        got = FL.fused_linear_cuda(x, w, b, act="gelu")
        assert FL.LAUNCHES.variants == {"wmma": 1}
        torch.testing.assert_close(got.float(), FL.fused_linear_plain(x, w, b, act="gelu").float(),
                                   **TOL_BF16)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("M,K,N", [(4, 3072, 768), (1, 768, 768), (128, 2560, 2560),
                                       (32, 768, 768), (2048, 768, 768)])
    def test_fused_linear_bitwise_repeatable(self, cuda_device, dtype, M, K, N):
        """No atomics: the split-K sums run in a fixed order, so two calls
        on the same inputs agree bit for bit."""
        g = torch.Generator(device=cuda_device).manual_seed(3)
        x = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
        w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).to(dtype)
        b = torch.randn(N, generator=g, device=cuda_device).to(dtype)
        first = FL.fused_linear_cuda(x, w, b, act="gelu")
        assert all(torch.equal(first, FL.fused_linear_cuda(x, w, b, act="gelu"))
                   for _ in range(3))

    @pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal", [
        (2, 4, 4, 1, 300, 64, True), (2, 4, 4, 1, 300, 16, False),  # one query row
        (1, 12, 4, 256, 256, 64, True), (1, 12, 4, 200, 200, 32, True),  # GQA 12/4
        (1, 12, 4, 130, 170, 16, False), (2, 4, 2, 33, 100, 64, True),
        (2, 4, 4, 100, 33, 64, False), (1, 2, 2, 384, 384, 32, True)])
    def test_flash_warpgroup_kernel(self, cuda_device, B, H, KVH, Sq, Sk, D, causal):
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _qkv(5, B, H, KVH, Sq, Sk, D))
        FA.LAUNCHES.reset()
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=causal)
        assert FA.LAUNCHES.variants == {"wgmma": 1}
        _assert_flash_bf16(got, q, k, v, D ** -0.5, causal)

    @pytest.mark.parametrize("D", FA.HEAD_DIMS)
    def test_flash_more_queries_than_keys_causal(self, cuda_device, D):
        """Sq > Sk, causal: query row r sees keys <= r + Sk - Sq, so the
        first Sq - Sk rows see none and write exactly 0."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _qkv(6, 2, 4, 4, 300, 100, D))
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=True)
        assert bool((got[:, :, :200] == 0).all())
        _assert_flash_bf16(got[:, :, 200:], q[:, :, 200:], k, v, D ** -0.5, True)

    @pytest.mark.parametrize("D", FA.HEAD_DIMS)
    def test_flash_transposed_views(self, cuda_device, D):
        """(B, S, H, D) projections handed over as (B, H, S, D) views, as the
        model does: the warpgroup kernel loads them with 4-D TMA (D = 256:
        the WMMA kernel, with 16-byte loads)."""
        g = torch.Generator(device=cuda_device).manual_seed(D)
        qkv = (torch.randn(2, 200, 3, 12, D, generator=g, device=cuda_device) * 1.5).bfloat16()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        want_variant = "wgmma" if D in FA.WGMMA_HEAD_DIMS else "wmma"
        assert not q.is_contiguous() and FA.variant(q, k, v) == want_variant
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=True)
        _assert_flash_bf16(got, q, k, v, D ** -0.5, True)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", [96, 112, 128, 256])
    @pytest.mark.parametrize("B,H,KVH,Sq,Sk,causal", [
        (2, 8, 2, 200, 200, True),  # GQA 8/2, a ragged query tile
        (1, 4, 4, 1, 300, False),  # one query row
        (2, 4, 1, 130, 330, True),  # MQA, Sq < Sk: causal offset Sk - Sq
        (1, 8, 2, 384, 384, False)])
    def test_flash_head_dims(self, cuda_device, dtype, D, B, H, KVH, Sq, Sk, causal):
        """The head dims the JAX kernel serves beyond 64: bf16 takes the
        warpgroup kernel up to 128 (96 and 112 padded to 128) and WMMA at
        256; f32 the FMA kernel with D split over 4 or 8 lanes a row."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(D + Sq, B, H, KVH, Sq, Sk, D))
        FA.LAUNCHES.reset()
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=causal)
        torch.cuda.synchronize()
        want_variant = ("fma" if dtype == torch.float32
                        else "wgmma" if D in FA.WGMMA_HEAD_DIMS else "wmma")
        assert FA.LAUNCHES.variants == {want_variant: 1}
        assert got.dtype == dtype and tuple(got.shape) == (B, H, Sq, D)
        if dtype == torch.float32:
            want = FA.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=causal)
            torch.testing.assert_close(got, want, **TOL_F32)
        else:
            _assert_flash_bf16(got, q, k, v, D ** -0.5, causal)

    @pytest.mark.parametrize("D", [96, 112, 128, 256])
    def test_flash_wmma_head_dims(self, cuda_device, D):
        """bf16 views TMA cannot take (a base on 2 bytes) at the new head
        dims: the WMMA kernel, its tiles in dynamic shared memory."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _qkv(D, 2, 4, 2, 150, 150, D))
        flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        qs = flat[1:].view(q.shape)
        qs.copy_(q)
        assert FA.variant(qs, k, v) == "wmma"
        FA.LAUNCHES.reset()
        got = FA.flash_attention_cuda(qs, k, v, scale=D ** -0.5, causal=True)
        assert FA.LAUNCHES.variants == {"wmma": 1}
        _assert_flash_bf16(got, q, k, v, D ** -0.5, True)

    def test_flash_smem_matches_the_entry_point(self, cuda_device):
        lib = FA._lib()
        for D in FA.HEAD_DIMS:
            for dtype, kinds in ((torch.float32, ("fma",)), (torch.bfloat16, ("wmma", "wgmma"))):
                for kind in kinds:
                    c = lib.forge_flash_attention_smem(FA.DTYPE_CODES[dtype],
                                                       FA.VARIANT_CODES[kind], D)
                    if kind == "wgmma" and D not in FA.WGMMA_HEAD_DIMS:
                        assert c == -1
                    else:
                        assert c == FA.smem_bytes(kind, D), (kind, D)

    def test_unsupported_head_dim_raises(self, cuda_device):
        """Above the largest built head dim there is no kernel to pad to."""
        q = torch.ones(1, 2, 8, 288, device=cuda_device)
        with pytest.raises(ValueError):
            FA.flash_attention_cuda(q, q, q, scale=1.0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D,Dp", [(8, 16), (48, 64)])
    def test_flash_pads_unbuilt_head_dim(self, cuda_device, dtype, D, Dp):
        """A head dim with no kernel of its own (the quickstart example's
        8) runs on the next built one, zero-padded: one launch, the
        unpadded shape out, the plain attention's values."""
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(D, 2, 8, 2, 64, 64, D))
        FA.LAUNCHES.reset()
        got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=True)
        torch.cuda.synchronize()
        assert FA.LAUNCHES.n == 1 and tuple(got.shape) == (2, 8, 64, D)
        assert got.is_contiguous()
        if dtype == torch.float32:
            want = FA.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=True)
            torch.testing.assert_close(got, want, **TOL_F32)
        else:
            assert FA.LAUNCHES.variants == {"wgmma": 1}
            _assert_flash_bf16(got, q, k, v, D ** -0.5, True)

    def test_dispatch_launches_kernels(self, cuda_device):
        FL.LAUNCHES.reset()
        FA.LAUNCHES.reset()
        x = torch.randn(3, 5, 64, device=cuda_device)
        ops.fused_linear(x, torch.randn(64, 32, device=cuda_device), act="gelu")
        q = torch.randn(1, 2, 16, 64, device=cuda_device)
        ops.sdpa(q, q, q, causal=True)
        ops.sdpa(q, q, q, causal=True, impl="ref")
        assert FL.LAUNCHES.n == 1 and FA.LAUNCHES.n == 1


@pytest.mark.cuda
def test_model_on_card_matches_plain_path(cuda_device):
    """Smoke model with D=64 heads on the card: kernels vs impl='ref'."""
    cfg = get_config("forge-125m", smoke=True).with_(n_heads=1, n_kv_heads=1,
                                                     dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device)
    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    got = m.apply(p, toks, cfg)
    assert FA.LAUNCHES.n == cfg.n_layers and FL.LAUNCHES.n == 3 * cfg.n_layers
    want = m.apply(p, toks, cfg, impl="ref")
    torch.testing.assert_close(got, want, **TOL_F32)


@pytest.mark.cuda
def test_serve_on_card_launches_kernels(cuda_device):
    cfg = get_config("forge-125m", smoke=True).with_(n_heads=1, n_kv_heads=1)
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    r = BatchedServer(cfg, p, max_len=16, mode="interpret").generate(prompts, 3)
    assert r["tokens"].shape == (2, 3)
    assert FL.LAUNCHES.n == 3 * cfg.n_layers * (4 + 3 - 1) and FA.LAUNCHES.n == 0


def paged_case(seed, B, H, KVH, D, ps, MP, NP, dtype, device):
    """Random non-contiguous page tables (page 0 never used), positions
    that include -1 (no key), a page's last slot, a page's first slot and
    the table's last slot."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((B, H, D)) * 1.5).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((NP, ps, KVH, D)) * 1.5).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, ps, KVH, D)).astype(np.float32))
    pt = np.stack([1 + rng.choice(NP - 1, MP, replace=False) for _ in range(B)])
    edges = [-1, ps - 1, ps, MP * ps - 1, 2 * ps + 3]
    pos = np.asarray([edges[(seed + b) % len(edges)] for b in range(B)], np.int32)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            torch.from_numpy(pt.astype(np.int32)).to(device),
            torch.from_numpy(pos).to(device))


#: (B, H, KVH, D, ps, MP, NP, window): forge-125m's served shapes, GQA
#: (qwen2.5-14b's 40 on 8: groups of 5 heads), a window, and the other
#: head dims
PAGED_CASES = [(1, 12, 12, 64, 16, 16, 129, None), (2, 12, 12, 64, 16, 16, 129, None),
               (4, 12, 12, 64, 16, 16, 129, None), (4, 12, 4, 64, 16, 16, 129, None),
               (4, 12, 12, 64, 16, 16, 129, 20), (3, 4, 2, 8, 8, 4, 13, None),
               (2, 8, 8, 16, 16, 6, 20, 9), (2, 8, 4, 32, 16, 6, 20, None),
               (2, 4, 4, 128, 16, 6, 20, None), (2, 8, 2, 96, 16, 6, 20, None),
               (2, 8, 2, 112, 16, 6, 20, 40), (3, 4, 1, 256, 16, 6, 20, None),
               (4, 32, 8, 128, 16, 16, 70, None), (4, 40, 8, 128, 16, 16, 70, None)]


@pytest.mark.cuda
class TestPagedAttentionOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,H,KVH,D,ps,MP,NP,window", PAGED_CASES)
    def test_kernel_matches_plain(self, cuda_device, dtype, B, H, KVH, D, ps, MP, NP, window):
        q, k, v, pt, pos = paged_case(B + D, B, H, KVH, D, ps, MP, NP, dtype, cuda_device)
        got = PA.paged_attention_cuda(q, k, v, pt, pos, window=window)
        want = PA.paged_attention_plain(q, k, v, pt, pos, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert bool((got[pos < 0] == 0).all())
        if dtype == torch.bfloat16:
            mass = PA.paged_attention_plain(q, k, v.abs(), pt, pos, window=window)
            err = (got.float() - want.float()).abs()
            bound = 3 * BF16_U * (mass.float() + want.float().abs())
            assert bool((err <= bound).all()), (err / bound).max()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("splits,chunk", [(1, 1), (1, 8), (3, 2), (16, 1), (5, 3),
                                              (40, 1)])
    @pytest.mark.parametrize("window", [None, 20])
    def test_forced_plans(self, cuda_device, dtype, splits, chunk, window):
        """Plans the planner does not pick: one block a row, one split per
        page of the table (16), more splits than pages (40), chunks of 1 to
        8 pages; rows at pos = -1, a page's edges and the table's last
        slot; GQA 12/4.  Every plan matches the plain version."""
        B, H, KVH, D, ps, MP, NP = 5, 12, 4, 64, 16, 16, 129
        q, k, v, pt, pos = paged_case(11, B, H, KVH, D, ps, MP, NP, dtype, cuda_device)
        assert sorted(pos.tolist()) == [-1, 15, 16, 35, 255]
        PA.LAUNCHES.reset()
        got = PA.paged_attention_cuda(q, k, v, pt, pos, window=window,
                                      plan_override=(splits, chunk))
        torch.cuda.synchronize()
        assert PA.LAUNCHES.n == 1
        want = PA.paged_attention_plain(q, k, v, pt, pos, window=window)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert bool((got[pos < 0] == 0).all())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,H,KVH,D,MP", [(4, 12, 12, 64, 16), (8, 12, 12, 64, 128),
                                              (4, 32, 8, 128, 128), (4, 40, 8, 128, 128)])
    def test_bitwise_repeatable(self, cuda_device, dtype, B, H, KVH, D, MP):
        """The partials are merged in split order, whichever block finishes
        last: calls on the same inputs agree bit for bit, and the tickets
        are back at 0 after each call."""
        q, k, v, pt, pos = paged_case(3, B, H, KVH, D, 16, MP, 1 + B * MP, dtype, cuda_device)
        pos = torch.full_like(pos, MP * 16 - 1)
        assert PA.plan(B, H, KVH, D, 16, MP, None, dtype)[0] > 1
        first = PA.paged_attention_cuda(q, k, v, pt, pos)
        assert all(torch.equal(first, PA.paged_attention_cuda(q, k, v, pt, pos))
                   for _ in range(4))
        torch.cuda.synchronize()
        tickets = [t for key, t in _build._SCRATCH.items() if key[0] == "paged_attention"]
        assert tickets and all(int(t.abs().sum()) == 0 for t in tickets)
        want = PA.paged_attention_plain(q, k, v, pt, pos)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(first.float(), want.float(), **tol)

    def test_smem_matches_the_entry_point(self, cuda_device):
        lib = PA._lib()
        for B, H, KVH, D, ps, MP, NP, window in PAGED_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                chunk = PA.plan(B, H, KVH, D, ps, MP, window, dtype)[1]
                assert lib.forge_paged_attention_smem(H // KVH, D, chunk * ps,
                                                      PA.DTYPE_CODES[dtype]) == \
                    PA.smem_bytes(H, KVH, D, ps, chunk, dtype)

    def test_front_launches_and_ref_does_not(self, cuda_device):
        q, k, v, pt, pos = paged_case(0, 2, 4, 4, 16, 8, 4, 9, torch.float32, cuda_device)
        PA.LAUNCHES.reset()
        PA.paged_attention(q, k, v, pt.long(), pos.long())
        PA.paged_attention(q, k, v, pt, pos, impl="ref")
        assert PA.LAUNCHES.n == 1

    def test_bad_inputs_raise(self, cuda_device):
        q, k, v, pt, pos = paged_case(0, 2, 4, 4, 16, 8, 4, 9, torch.float32, cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            x = torch.ones(2, 4, 48, device=cuda_device)
            PA.paged_attention_cuda(x, torch.ones(9, 8, 4, 48, device=cuda_device),
                                    torch.ones(9, 8, 4, 48, device=cuda_device), pt, pos)
        with pytest.raises(ValueError, match="int32"):
            PA.paged_attention_cuda(q, k, v, pt.long(), pos)


def _paged_sched_run(cfg, p, **kw):
    srv = BatchedServer(cfg, p, max_len=32, mode="forge", seq_bucket_policy="ladder:8,16,32",
                        paged=True, kv_page_size=8, **kw)
    sched = SlotScheduler(srv, max_slots=4)
    sched.warmup(prompt_lens=[4, 8, 16, 24])
    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    PA.LAUNCHES.reset()
    res = sched.run(paged_workload(Request, cfg.vocab))
    counts = (FL.LAUNCHES.n, FA.LAUNCHES.n, PA.LAUNCHES.n)
    srv.page_pool.check()
    assert srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages
    assert res["compiles"] == 0
    return res, counts


@pytest.mark.cuda
@pytest.mark.parametrize("kv_kernel", ["pallas", "ref"])
def test_paged_scheduler_on_card(cuda_device, kv_kernel):
    """The whole paged step captured on the card through both routes: the
    paged kernel inside the capture ("pallas"), and Forge-compiled block
    bodies whose fused-linear kernel calls the capture meets ("ref").
    Tokens equal the impl="ref" run's; the kernels were launched."""
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32", kv_kernel=kv_kernel)
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    got, (fl, fa, pa) = _paged_sched_run(cfg, p)
    want, ref_counts = _paged_sched_run(cfg, p, impl="ref")
    assert ref_counts == (0, 0, 0)
    for rid, r in want["results"].items():
        np.testing.assert_array_equal(got["results"][rid]["tokens"], r["tokens"])
    assert fa == 0
    assert pa == (cfg.n_layers * got["decode_dispatches"] if kv_kernel == "pallas" else 0)
    assert fl == 3 * cfg.n_layers * (got["decode_dispatches"] + got["prefill_dispatches"])


# --------------------------------------------------------------------------
# the RG-LRU scan and the recurrentgemma hybrid on the card
# --------------------------------------------------------------------------

#: (B, T, D, nonzero h0): the served prefill cells of recurrentgemma-2b,
#: its full-sequence forward, and a ragged T and D
RG_SHAPES = [(4, 32, 2560, True), (4, 64, 2560, True), (2, 1024, 2560, False),
             (3, 37, 100, True)]


def _rg_inputs(device, dtype, B, T, D, with_h0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, T, D, generator=g, device=device).to(dtype)
    a = (0.3 + 0.699 * torch.rand(B, T, D, generator=g, device=device)).to(dtype)
    h0 = (torch.randn(B, D, generator=g, device=device) if with_h0
          else torch.zeros(B, D, device=device))
    return x, a, h0


@pytest.mark.cuda
class TestRgLruOnCard:
    """The RG-LRU kernel against its plain version: f32 rtol 2e-4 / atol
    2e-5, bf16 3e-2; the chunked entry point's ``last`` is ``h[:, -1]``
    bitwise."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,T,D,with_h0", RG_SHAPES)
    def test_rg_lru(self, cuda_device, dtype, B, T, D, with_h0):
        x, a, h0 = _rg_inputs(cuda_device, dtype, B, T, D, with_h0)
        want = RG.rg_lru_plain(x, a, h0)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(RG.rg_lru_cuda(x, a, h0).float(), want.float(), **tol)
        h, last = RG.rg_lru_cuda(x, a, h0, last=True)
        torch.testing.assert_close(h.float(), want.float(), **tol)
        assert h.dtype == dtype and last.dtype == dtype
        assert torch.equal(last, h[:, -1])

    def test_chained_chunks_equal_one_scan(self, cuda_device):
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, 2, 100, 300, True, seed=1)
        full = RG.rg_lru_cuda(x, a, h0)
        carry, parts = h0, []
        for lo, hi in ((0, 7), (7, 40), (40, 64), (64, 100)):
            h, carry = ops.rg_lru_scan(x[:, lo:hi], a[:, lo:hi], carry)
            parts.append(h)
        torch.testing.assert_close(torch.cat(parts, 1), full, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,T,D", [(2, 1, 2560), (3, 37, 100), (2, 100, 300),
                                       (2, 1024, 2560), (1, 130, 129)])
    @pytest.mark.parametrize("steps", [1, 7, 32, 64])
    def test_forced_chunks(self, cuda_device, dtype, B, T, D, steps):
        """Chunk lengths the planner does not pick, down to one step a
        chunk (T look-backs deep), a ragged last chunk, T = 1 and D not a
        multiple of 128, with and without ``last``."""
        x, a, h0 = _rg_inputs(cuda_device, dtype, B, T, D, True, seed=T + steps)
        want = RG.rg_lru_plain(x, a, h0)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        RG.LAUNCHES.reset()
        torch.testing.assert_close(RG.rg_lru_cuda(x, a, h0, steps=steps).float(), want.float(),
                                   **tol)
        h, last = RG.rg_lru_cuda(x, a, h0, last=True, steps=steps)
        torch.cuda.synchronize()
        assert RG.LAUNCHES.n == 2
        torch.testing.assert_close(h.float(), want.float(), **tol)
        assert torch.equal(last, h[:, -1])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,T,D", [(2, 1024, 2560), (4, 128, 2560), (3, 37, 100)])
    def test_bitwise_repeatable(self, cuda_device, dtype, B, T, D):
        """The carries are folded in chunk order however far a block looks
        back: calls on the same inputs agree bit for bit."""
        assert RG.plan(B, T, D)[0] > 1
        x, a, h0 = _rg_inputs(cuda_device, dtype, B, T, D, True, seed=5)
        first = RG.rg_lru_cuda(x, a, h0)
        assert all(torch.equal(first, RG.rg_lru_cuda(x, a, h0)) for _ in range(4))

    def test_one_chunk_plans_chain_bitwise(self, cuda_device):
        """Where every call's plan is one chunk, the sequential chain runs:
        chained calls carried through ``last`` equal one scan bitwise."""
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, 4, 32, 2560, True, seed=2)
        assert RG.plan(4, 32, 2560)[0] == 1
        full = RG.rg_lru_cuda(x, a, h0)
        carry, parts = h0, []
        for lo, hi in ((0, 7), (7, 20), (20, 32)):
            h, carry = ops.rg_lru_scan(x[:, lo:hi], a[:, lo:hi], carry)
            parts.append(h)
        assert torch.equal(torch.cat(parts, 1), full)

    def test_dispatch_launches_kernel(self, cuda_device):
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, 2, 9, 64, True)
        RG.LAUNCHES.reset()
        ops.rg_lru(x, a, h0)
        ops.rg_lru_scan(x, a)
        ops.rg_lru(x, a, h0, impl="ref")
        assert RG.LAUNCHES.n == 2

    def test_bad_operands_raise(self, cuda_device):
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, 2, 9, 64, True)
        with pytest.raises(ValueError):
            RG.rg_lru_cuda(x, a.bfloat16(), h0)
        with pytest.raises(ValueError):
            RG.rg_lru_cuda(x.transpose(1, 2), a.transpose(1, 2), h0)


@pytest.mark.cuda
def test_rglru_server_on_card_matches_plain_path(cuda_device):
    """The recurrentgemma smoke server (f32) through the contiguous forge
    fronts on the card: tokens equal the impl="ref" server's; the scan
    kernel launched once per rec layer per prefill dispatch and never in
    decode; ``apply``'s Forge bodies match the plain path."""
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    n_rec = sum(k == "rec" for k in m.module._pattern(cfg))
    srv = BatchedServer(cfg, p, max_len=32, mode="forge")
    srv.warmup([3], [6])
    RG.LAUNCHES.reset()
    got = srv.generate(prompts, 5)
    assert got["prefill_mode"] == "chunked" and got["compile_s"] == 0.0
    assert RG.LAUNCHES.n == n_rec  # one prefill dispatch, no decode launches
    RG.LAUNCHES.reset()
    want = BatchedServer(cfg, p, max_len=32, mode="forge", impl="ref").generate(prompts, 5)
    assert RG.LAUNCHES.n == 0
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda_device)
    RG.LAUNCHES.reset()
    logits = m.apply(p, toks, cfg)
    assert RG.LAUNCHES.n == n_rec
    torch.testing.assert_close(logits, m.apply(p, toks, cfg, impl="ref"), **TOL_F32)


#: (rows, d): xLSTM's decode block norm, the B4 x S32 prefill block norm,
#: norm_h at B4 x H4 x S32, apply at B2 x S1024, ragged widths and a row
#: longer than the registers hold
RMS_SHAPES = [(4, 1024), (128, 1024), (512, 512), (2048, 1024), (3, 1000), (5, 37),
              (2, 20000)]


@pytest.mark.cuda
class TestRmsNormOnCard:
    """The RMSNorm kernel against its plain version: f32 rtol 2e-4 / atol
    2e-5, bf16 3e-2."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("rows,d", RMS_SHAPES)
    def test_rms_norm(self, cuda_device, dtype, rows, d):
        g = torch.Generator(device=cuda_device).manual_seed(rows + d)
        x = (torch.randn(rows, d, generator=g, device=cuda_device) * 2).to(dtype)
        w = torch.rand(d, generator=g, device=cuda_device) + 0.5
        got = RN.rms_norm_cuda(x, w, 1e-6)
        assert got.dtype == dtype and got.shape == x.shape
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), RN.rms_norm_plain(x, w).float(), **tol)

    def test_misaligned_rows_take_the_scalar_path(self, cuda_device):
        flat = torch.randn(4 * 64 + 1, device=cuda_device)
        x = flat[1:].view(4, 64)  # 4 bytes past a 16-byte boundary
        w = torch.rand(64, device=cuda_device)
        torch.testing.assert_close(RN.rms_norm_cuda(x, w), RN.rms_norm_plain(x, w), **TOL_F32)

    def test_dispatch_launches_kernel(self, cuda_device):
        x = torch.randn(2, 3, 48, device=cuda_device)
        w = torch.rand(48, device=cuda_device)
        RN.LAUNCHES.reset()
        got = ops.rms_norm(x.transpose(0, 1), w, eps=1e-5)
        ops.rms_norm(x, w, impl="ref")
        assert RN.LAUNCHES.n == 1 and got.shape == (3, 2, 48)
        torch.testing.assert_close(got, RN.rms_norm_plain(x.transpose(0, 1), w, 1e-5),
                                   **TOL_F32)

    def test_bad_operands_raise(self, cuda_device):
        x = torch.randn(4, 8, device=cuda_device)
        with pytest.raises(ValueError):
            RN.rms_norm_cuda(x.t(), torch.ones(4, device=cuda_device))  # not contiguous
        with pytest.raises(ValueError):
            RN.rms_norm_cuda(x.half(), torch.ones(8, device=cuda_device))
        with pytest.raises(ValueError):
            RN.rms_norm_cuda(x, torch.ones(7, device=cuda_device))


@pytest.mark.cuda
def test_xlstm_server_on_card_matches_plain_path(cuda_device):
    """The xlstm smoke server (f32) through the contiguous forge fronts and
    the contiguous slot scheduler on the card: tokens equal the
    impl="ref" servers'; fused linear launched, nothing compiled after
    warmup; ``apply``'s Forge bodies match the plain path."""
    cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    srv = BatchedServer(cfg, p, max_len=32, mode="forge")
    srv.warmup([3], [6])
    FL.LAUNCHES.reset()
    RN.LAUNCHES.reset()
    got = srv.generate(prompts, 5)
    assert got["prefill_mode"] == "chunked" and got["compile_s"] == 0.0
    assert FL.LAUNCHES.n > 0 and RN.LAUNCHES.n == 0  # the norms are plain, as in JAX
    ref = BatchedServer(cfg, p, max_len=32, mode="forge", impl="ref")
    FL.LAUNCHES.reset()
    want = ref.generate(prompts, 5)
    assert FL.LAUNCHES.n == 0
    np.testing.assert_array_equal(got["tokens"], want["tokens"])

    def reqs():
        rng = np.random.default_rng(1)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (3 + 2 * i,)).astype(np.int32),
                        max_new=2 + i % 3, arrival=i // 2) for i in range(5)]

    res = SlotScheduler(srv, max_slots=2).run(reqs())
    res_ref = SlotScheduler(ref, max_slots=2).run(reqs())
    assert res["swaps"] >= 1 and res["prefill_dispatches"] >= 2
    for rid, r in res_ref["results"].items():
        np.testing.assert_array_equal(res["results"][rid]["tokens"], r["tokens"])
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda_device)
    torch.testing.assert_close(m.apply(p, toks, cfg), m.apply(p, toks, cfg, impl="ref"),
                               **TOL_F32)


# --------------------------------------------------------------------------
# CUDA graphs: the kernels replayed, and the segment_jit backend
# --------------------------------------------------------------------------


def _graphed(fn, *args):
    """``fn(*args)`` captured in one CUDA graph after a warm call on the
    capture stream (the kernels' per-stream scratch is made there, outside
    the capture); returns (graph, the output tensors the replays write)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(*args)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = fn(*args)
    return g, out


def _refill(tensors, seed):
    g = torch.Generator(device=tensors[0].device).manual_seed(seed)
    for t in tensors:
        t.copy_(torch.rand(t.shape, generator=g, device=t.device) * 0.699 + 0.3)


@pytest.mark.cuda
class TestGraphReplayOnCard:
    """Each served kernel launched inside ``torch.cuda.graph`` and replayed
    on new inputs equals its plain version and its eager launch on the
    same inputs, bitwise."""

    @pytest.mark.parametrize("M,K,N,act", [(4, 768, 3072, "gelu"), (128, 2560, 2560, None),
                                           (256, 768, 768, None)])
    def test_fused_linear_replayed(self, cuda_device, M, K, N, act):
        g = torch.Generator(device=cuda_device).manual_seed(M)
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).bfloat16()
        b = torch.randn(N, generator=g, device=cuda_device).bfloat16()
        FL.LAUNCHES.reset()
        graph, out = _graphed(lambda: FL.fused_linear(x, w, b, act=act))
        launched = FL.LAUNCHES.n
        for seed in (1, 2):
            x.copy_(torch.randn(M, K, generator=g, device=cuda_device))
            graph.replay()
            torch.testing.assert_close(out.float(), FL.fused_linear_plain(x, w, b, act=act)
                                       .float(), **TOL_BF16)
            assert torch.equal(out, FL.fused_linear(x, w, b, act=act))
        assert launched == 2  # the warm call and the capture; replays run no wrapper

    @pytest.mark.parametrize("plan", [None, (16, 1), (3, 2)])
    def test_paged_tickets_across_replays(self, cuda_device, plan):
        """Split plans merge through tickets the last block re-arms: they
        stay armed across replays of a captured launch."""
        q, k, v, pt, pos = paged_case(3, 4, 12, 12, 64, 16, 16, 129, torch.bfloat16, cuda_device)
        pos.copy_(torch.tensor([200, 31, 17, 255], dtype=torch.int32))
        graph, out = _graphed(lambda: PA.paged_attention_cuda(q, k, v, pt, pos,
                                                               plan_override=plan))
        for seed in range(3):
            _refill([k, v], seed)
            q.copy_(torch.randn(q.shape, device=cuda_device))
            graph.replay()
            want = PA.paged_attention_plain(q, k, v, pt, pos)
            torch.testing.assert_close(out.float(), want.float(), **TOL_BF16)
            assert torch.equal(out, PA.paged_attention_cuda(q, k, v, pt, pos,
                                                            plan_override=plan))

    @pytest.mark.parametrize("B,T,D,steps", [(4, 32, 2560, None), (4, 128, 2560, None),
                                             (2, 300, 300, 7)])
    def test_rg_lru_replayed_on_new_inputs(self, cuda_device, B, T, D, steps):
        """A multi-chunk plan's look-back reads flags of the replay's own
        epoch, which the kernel advances on the device: every replay on new
        inputs equals the plain version and the eager launch bitwise."""
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, B, T, D, True, seed=B + T)
        chunks = RG.plan(B, T, D)[0] if steps is None else -(-T // steps)
        assert (chunks > 1) == (T > 32)
        graph, out = _graphed(lambda: RG.rg_lru_cuda(x, a, h0, steps=steps))
        for seed in range(3):
            g = torch.Generator(device=cuda_device).manual_seed(seed)
            x.copy_(torch.randn(x.shape, generator=g, device=cuda_device))
            a.copy_(0.3 + 0.699 * torch.rand(a.shape, generator=g, device=cuda_device))
            graph.replay()
            torch.testing.assert_close(out, RG.rg_lru_plain(x, a, h0), **TOL_F32)
            assert torch.equal(out, RG.rg_lru_cuda(x, a, h0, steps=steps))

    def test_scratch_is_not_made_inside_a_capture(self, cuda_device):
        x, a, h0 = _rg_inputs(cuda_device, torch.float32, 3, 200, 96, True)
        s = torch.cuda.Stream()
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
            with torch.cuda.graph(g, stream=s):
                RG.rg_lru_cuda(x, a, h0, steps=8)


def _smoke_server(arch, cuda_device, backend, **kw):
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    return cfg, p, BatchedServer(cfg, p, max_len=32, mode="forge", backend=backend, **kw)


def _counts():
    return {mod.__name__: (mod.LAUNCHES.n, dict(mod.LAUNCHES.variants))
            for mod in (FL, FA, PA, RG, RN)}


def _reset_counts():
    for mod in (FL, FA, PA, RG, RN):
        mod.LAUNCHES.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["forge-125m", "recurrentgemma-2b", "xlstm-350m",
                                  "qwen2.5-14b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                                  "qwen2-vl-72b"])
def test_segment_jit_equals_interpret_on_card(cuda_device, arch):
    """The smoke server's tokens under segment_jit are interpret's,
    bitwise; every launch the interpret run counts, by kernel and
    variant, the graph replays count too; no capture after warmup."""
    from repro_torch.core.backends.segment_jit import CAPTURES

    prompts = np.random.default_rng(0).integers(0, 400, (3, 6)).astype(np.int32)
    runs = {}
    for backend in ("interpret", "segment_jit"):
        _, _, srv = _smoke_server(arch, cuda_device, backend)
        srv.warmup([3], [6])
        captured = dict(CAPTURES)
        _reset_counts()
        res = srv.generate(prompts, 5)
        torch.cuda.synchronize()
        runs[backend] = (res["tokens"], _counts())
        assert CAPTURES == captured
    np.testing.assert_array_equal(runs["segment_jit"][0], runs["interpret"][0])
    assert runs["segment_jit"][1] == runs["interpret"][1]
    assert runs["segment_jit"][1][FL.__name__][0] > 0
    s = srv.forge_module.stats
    assert s.last_segments_executed == s.n_segments and s.capture_s > 0


@pytest.mark.cuda
def test_segment_jit_outputs_survive_and_params_are_pinned(cuda_device):
    """Outputs a caller keeps stay intact after the program's next call;
    a parameter tensor that moved raises, naming it; an input off the card
    raises."""
    cfg, p, srv = _smoke_server("forge-125m", cuda_device, "segment_jit")
    srv.warmup([2], [6])
    mod = srv.prefill_bucketed.programs[srv.prefill_bucketed.key_for_extents((2, 16))]
    ref = mod.with_backend("interpret")

    def args(seed):
        toks = torch.randint(0, cfg.vocab, (2, 16), device=cuda_device,
                             generator=torch.Generator(device=cuda_device).manual_seed(seed))
        return (srv._build_cache(2),) + srv._prefill_args(2, toks.to(torch.int32), 0)

    a1, a2 = args(1), args(2)
    first = mod(p, *a1)
    second = mod(p, *a2)
    for got, want in ((first, ref(p, *a1)), (second, ref(p, *a2))):
        assert all(torch.equal(g, w) for g, w in zip(torch.utils._pytree.tree_leaves(got),
                                                      torch.utils._pytree.tree_leaves(want)))
    moved = dict(p, embed=p["embed"].clone())
    with pytest.raises(ValueError, match=r"args\[0\]\['embed'\]"):
        mod(moved, *a1)
    fresh = mod.with_backend("segment_jit")
    with pytest.raises(ValueError, match="on cpu"):
        fresh(p, a1[0], a1[1].cpu(), *a1[2:])


@pytest.mark.cuda
def test_segment_capture_error_names_the_op(cuda_device):
    """An op that syncs the host cannot be captured: the segment raises with
    its index and the op, and nothing falls back to per-op replay."""
    from repro_torch.core.backends.segment_jit import SegmentCaptureError, SegmentJitBackend
    from repro_torch.core.graph import Aval
    from repro_torch.core.lowering import RegRef, RGIROp, RGIRProgram

    x = torch.ones(4, device=cuda_device)
    aval = Aval.of(x)
    ops_ = [RGIROp(0, "host.aten.mul.Tensor", "host", lambda t: t * 2, (RegRef(0),), (0,), (1,)),
            RGIROp(1, "host.aten._local_scalar_dense.default", "host",
                   lambda t: t + t.sum().item(), (RegRef(1),), (1,), (2,))]
    prog = RGIRProgram(ops=ops_, n_vregs=3, input_regs=[0], output_regs=[2], constants={},
                       reg_avals={0: aval, 1: aval, 2: aval})
    ex = SegmentJitBackend().build(prog)
    assert torch.equal(ex.execute(x.cpu())[0], torch.full((4,), 10.0))  # the CPU path
    with pytest.raises(SegmentCaptureError, match=r"segment 0 .*op 1 host\.aten\._local_scalar"):
        ex.execute(x)


# --------------------------------------------------------------------------
# qwen2.5-14b's shapes: forge.swiglu and GQA flash with 5 query heads a KV head
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 128])
def test_swiglu_is_two_fused_linear_launches(cuda_device, M):
    """``ops.swiglu`` on the card: the gate with the silu epilogue and the
    up projection, two fused-linear launches, then their product; within
    the bf16 tolerance of ``ops.swiglu(impl="ref")`` at qwen2.5-14b's
    widths (K 5120, N 13824)."""
    from repro_torch.kernels import ref

    K, N = 5120, 13824
    g = torch.Generator(device=cuda_device).manual_seed(M)
    x = (torch.randn(M, K, generator=g, device=cuda_device) * 0.5).bfloat16()
    wg, wu = ((torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).bfloat16()
              for _ in range(2))
    FL.LAUNCHES.reset()
    got = ops.swiglu(x, wg, wu)
    torch.cuda.synchronize()
    assert FL.LAUNCHES.n == 2 and set(FL.LAUNCHES.variants) <= {"gemv", "wgmma"}
    gate = FL.fused_linear_cuda(x, wg, None, act="silu")
    up = FL.fused_linear_cuda(x, wu, None, act=None)
    assert torch.equal(got, gate * up)
    torch.testing.assert_close(got.float(), ops.swiglu(x, wg, wu, impl="ref").float(),
                               **TOL_BF16)
    torch.testing.assert_close(ops.swiglu(x, wg, wu, impl="ref"), ref.swiglu_ref(x, wg, wu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,causal", [(256, True), (300, True), (1, False)])
def test_flash_qwen_gqa(cuda_device, dtype, S, causal):
    """Flash at H=40, KVH=8 (5 query heads a KV head), D=128."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(40, 1, 40, 8, S, S if causal else 77, 128))
    got = FA.flash_attention_cuda(q, k, v, scale=128 ** -0.5, causal=causal)
    if dtype == torch.bfloat16:
        assert FA.variant(q, k, v) == "wgmma"
        _assert_flash_bf16(got, q, k, v, 128 ** -0.5, causal)
    else:
        want = FA.flash_attention_plain(q, k, v, scale=128 ** -0.5, causal=causal)
        torch.testing.assert_close(got, want, **TOL_F32)


@pytest.mark.cuda
def test_folded_and_promoted_constants_survive_replays(cuda_device):
    """A folded constant (a RoPE-like table) and a promoted factory stay at
    their address and keep their values across segment_jit replays: every
    replay equals the interpret program's result on new inputs."""
    from repro_torch.core import PipelineConfig, forge_compile

    def f(x):
        table = torch.arange(64, device=x.device, dtype=torch.float32) * 0.25 + 1.0
        return torch.relu(x * table + torch.full((64,), 2.0, device=x.device)) @ x.t()

    x0 = torch.randn(8, 64, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(9))
    for cfg in (PipelineConfig(), PipelineConfig(enable={"constant_folding": False})):
        mod = forge_compile(f, x0, config=cfg, backend="segment_jit")
        rows = {r["pass"]: r["detail"] for r in mod.result.pass_table()}
        assert rows.get("constant_folding", {}).get("folded", 0) + \
            rows["device_constant"]["promoted"] > 0
        consts = [c for c in mod.program.constants.values()]
        assert consts and all(c.is_cuda for c in consts)
        ptrs = [c.data_ptr() for c in consts]
        twin = mod.with_backend("interpret")
        for seed in range(3):
            x = torch.randn(8, 64, device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(seed))
            assert torch.equal(mod(x), twin(x))
            torch.testing.assert_close(mod(x), f(x), **TOL_F32)
        assert [c.data_ptr() for c in mod.program.constants.values()] == ptrs
        assert mod.executor.captured


# --------------------------------------------------------------------------
# the compile cache and the compile service on the card
# --------------------------------------------------------------------------


def _linear_gelu(x, w, b):
    return torch.nn.functional.gelu(x @ w + b)


def _causal_attn(q, k, v):
    """Causal attention written unfused: Phase 2 fuses it into
    ``forge.sdpa`` (flash attention on the card)."""
    S = q.shape[2]
    s = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / q.shape[-1] ** 0.5)
    row = torch.arange(S, device=q.device).view(S, 1)
    col = torch.arange(S, device=q.device).view(1, S)
    s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


@pytest.mark.cuda
def test_background_capture_while_replaying(cuda_device):
    """A compile-service worker captures one program (flash attention) on
    its own stream while the main thread replays another (fused linear)
    and checks every result: the replays stay bitwise, the worker's
    capture records only its own launches, and its program then replays
    bitwise equal to its interpret twin."""
    from repro_torch.core import CompileCache, CompileService, ForgeCompiler, PipelineConfig

    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(64, 768, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(768, 768, generator=g, device=cuda_device) / 28).bfloat16()
    b = torch.randn(768, generator=g, device=cuda_device).bfloat16()
    qkv = [torch.randn(2, 4, 256, 64, generator=g, device=cuda_device).bfloat16()
           for _ in range(3)]
    comp = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=CompileCache())
    lin = comp.compile(_linear_gelu, x, w, b)
    want = lin.with_backend("interpret")(x, w, b)
    svc = CompileService(workers=1)
    try:
        fut = svc.submit("attn", lambda: comp.compile(_causal_attn, *qkv))
        replays = 0
        while not fut.done() or replays < 3:
            assert torch.equal(lin(x, w, b), want)
            replays += 1
        attn = svc.result(fut, timeout=300.0)
    finally:
        svc.shutdown()
    assert attn.executor.captured and replays >= 3
    recorded = {i for graph_launches in attn.executor._replay[0] for i, _, _ in graph_launches[1]}
    assert recorded == {FA.LAUNCHES.index}
    assert torch.equal(attn(*qkv), attn.with_backend("interpret")(*qkv))


@pytest.mark.cuda
def test_evict_cold_frees_graph_pools(cuda_device):
    """``evict_cold`` drops the evicted programs from the table and from
    the compile cache: their CUDA graphs and pools are freed, so the
    reserved memory falls."""
    import gc

    from repro_torch.core import CompileCache, ForgeCompiler, PipelineConfig

    w = torch.randn(2048, 2048, device=cuda_device) / 45

    def f(x, w):
        return torch.tanh(x @ w) @ w

    cache = CompileCache()
    mod = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=cache).compile_bucketed(
        f, in_axes=(0, None), policy="pow2", static_argnums=(1,))
    for B in (2048, 4096, 8192):
        mod(torch.randn(B, 2048, device=cuda_device), w)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    victims = mod.evict_cold(1)
    assert len(victims) == 2 and len(cache) == 1 and cache.stats.coherence_drops == 2
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    # the two smaller programs' pools hold at least their outputs
    assert before - after >= (2048 + 4096) * 2048 * 4, (before, after)
    y = mod(torch.ones(3000, 2048, device=cuda_device), w)  # rebuilt on dispatch
    assert mod.stats.compiles == 4 and y.shape == (3000, 2048)


@pytest.mark.cuda
def test_disk_replay_graphs_equal_fresh_build(cuda_device, tmp_path):
    """A program rebuilt from a disk entry captures its graphs again; its
    outputs equal a fresh build's bitwise, on the served forge-125m smoke
    prefill cell."""
    from repro_torch.core import CompileCache, DiskCacheStore

    from repro_torch.core import get_compile_cache

    cfg, p, _ = _smoke_server("forge-125m", cuda_device, "segment_jit")
    store0 = get_compile_cache().store
    outs = []
    for cache_dir in (tmp_path, tmp_path, None):
        srv = BatchedServer(cfg, p, max_len=32, mode="forge", backend="segment_jit",
                            cache_dir=None if cache_dir is None else str(cache_dir))
        if cache_dir is None:  # a fresh build: a private memory tier, no disk
            srv.compile_cache = CompileCache()
        srv._ensure_bucketed()
        toks = torch.arange(32, device=cuda_device, dtype=torch.int32).view(2, 16) % cfg.vocab
        args = (srv._build_cache(2),) + srv._prefill_args(2, toks, 0)
        mod, _, _ = srv.prefill_bucketed.program_for(p, *args)
        outs.append((mod.result, mod(p, *args)))
        srv.compile_cache.clear()  # the next server starts from disk only
    get_compile_cache().store = store0
    (first, a), (replay, b), (fresh, c) = outs
    assert not first.cache_hit and replay.cache_disk_hit and not fresh.cache_disk_hit
    for x, y in ((a, b), (b, c)):
        assert all(torch.equal(s, t) for s, t in zip(torch.utils._pytree.tree_leaves(x),
                                                      torch.utils._pytree.tree_leaves(y)))
    assert isinstance(DiskCacheStore(str(tmp_path)).load_entry(replay.cache_key), dict)


@pytest.mark.cuda
def test_captured_programs_keep_their_own_scratch(cuda_device):
    """Two programs that run the multi-chunk RG-LRU scan (its flags and
    epoch live in kernel scratch): a compile worker warm-runs and captures
    the second while the main thread replays the first; every replay
    equals the first output bitwise, the second program equals its
    interpret twin, and each program's graphs hold scratch of their own."""
    from repro_torch.core import CompileCache, CompileService, ForgeCompiler, PipelineConfig

    x, a, h0 = _rg_inputs(cuda_device, torch.float32, 4, 128, 2560, True, seed=3)
    assert RG.plan(4, 128, 2560)[0] > 1  # chunks with a chained look-back

    def f(x, a, h0):
        return ops.rg_lru(x, a, h0) * 2.0

    def g(x, a, h0):
        return ops.rg_lru(x, a, h0) + 1.0

    comp = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=CompileCache())
    pf = comp.compile(f, x, a, h0)
    want = pf.with_backend("interpret")(x, a, h0)
    svc = CompileService(workers=1)
    try:
        fut = svc.submit("g", lambda: comp.compile(g, x, a, h0))
        replays = 0
        while not fut.done() or replays < 3:
            assert torch.equal(pf(x, a, h0), want)
            replays += 1
        pg = svc.result(fut, timeout=300.0)
    finally:
        svc.shutdown()
    assert torch.equal(pg(x, a, h0), pg.with_backend("interpret")(x, a, h0))
    scopes = {k[3] for k in _build._SCRATCH if k[0] == "rg_lru"}
    assert {id(pf.executor), id(pg.executor)} <= scopes


# --------------------------------------------------------------------------
# fault containment on the card: a retried mid-graph dispatch fault, and
# a parked contiguous row across later replays
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_chaos_dispatch_fault_mid_graph_retries_bitwise(cuda_device):
    """A dispatch fault before segment k > 0 of a captured paged decode
    program: the call raises with the caller's store untouched, the
    launch counters hold the replays of segments 0..k-1 only, and the
    retry's tokens and store are an unfaulted call's, bitwise."""
    from repro_torch.runtime import chaos

    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32", kv_kernel="pallas")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    srv = BatchedServer(cfg, p, max_len=32, mode="forge", paged=True, kv_page_size=8,
                        seq_bucket_policy="ladder:8")
    srv.warmup([2])
    mod = srv.bucketed.programs[srv.bucketed.key_for_extents(2)]
    ex = mod.executor
    n_seg = len(ex.segments)
    k = n_seg // 2
    assert k > 0
    pt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32, device=cuda_device)
    tok = torch.tensor([[11], [222]], dtype=torch.int32, device=cuda_device)
    pos = torch.tensor([5, 9], dtype=torch.int32, device=cuda_device)
    mask = torch.ones(2, dtype=torch.bool, device=cuda_device)
    store = {n: torch.randn_like(v) for n, v in srv.page_store.items()}
    before = {n: v.clone() for n, v in store.items()}
    want_tok, want_store = mod(p, store, pt, tok, pos, mask)
    torch.cuda.synchronize()
    paged_per_seg = [sum(n for i, n, _ in launches if i == PA.LAUNCHES.index)
                     for _, launches in ex._replay[0]]
    PA.LAUNCHES.reset()
    runs0 = list(ex.segment_runs)
    prev = chaos.install_plan(chaos.FaultPlan().arm(chaos.SITE_DISPATCH, times=(k,)))
    try:
        with pytest.raises(chaos.InjectedFault):
            mod(p, store, pt, tok, pos, mask)
        torch.cuda.synchronize()
        ran = [a - b for a, b in zip(ex.segment_runs, runs0)]
        assert ran == [1] * k + [0] * (n_seg - k)
        assert PA.LAUNCHES.n == sum(paged_per_seg[:k])
        assert all(torch.equal(store[n], before[n]) for n in store)
        got_tok, got_store = mod(p, store, pt, tok, pos, mask)
        torch.cuda.synchronize()
    finally:
        chaos.install_plan(prev)
    assert PA.LAUNCHES.n == sum(paged_per_seg[:k]) + cfg.n_layers
    assert torch.equal(got_tok, want_tok)
    assert all(torch.equal(got_store[n], want_store[n]) for n in store)


@pytest.mark.cuda
def test_parked_contiguous_row_survives_graph_replays(cuda_device):
    """A contiguous cache row parked in the bucket BufferPool owns its
    storage: later replays of the decode program (which write the graph
    pool and the program's own input tensors) leave it bitwise unchanged,
    and blending it back restores the row."""
    from repro_torch.launch.steps import blend_cache_rows, gather_cache_rows

    cfg, p, srv = _smoke_server("forge-125m", cuda_device, "segment_jit")
    srv.warmup([2])
    mod = srv.bucketed.programs[srv.bucketed.key_for_extents(2)]
    cache = srv._acquire_cache(2)
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def step(cache, pos):
        tok = torch.randint(0, cfg.vocab, (2, 1), dtype=torch.int32, device=cuda_device,
                            generator=g)
        return mod(p, cache, *srv._decode_args(2, tok, pos))[1]

    for pos in range(3):
        cache = step(cache, pos)
    row = gather_cache_rows(cache, srv.cache_axes, [1])
    snap = [t.clone() for t in torch.utils._pytree.tree_leaves(row)]
    srv.bucketed.pool.release(("parked", 7), row)
    for pos in range(3, 9):
        cache = step(cache, pos)
    torch.cuda.synchronize()
    back = srv.bucketed.pool.acquire(("parked", 7), lambda: None)
    srv.bucketed.pool.drop(("parked", 7))
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(back), snap))
    blended = blend_cache_rows(cache, srv.cache_axes, back, [0])
    for leaf, ax, want in zip(torch.utils._pytree.tree_leaves(blended),
                              torch.utils._pytree.tree_leaves(srv.cache_axes), snap):
        if ax is not None:
            assert torch.equal(leaf.narrow(ax, 0, 1), want)


# --------------------------------------------------------------------------
# the jit serve mode and the autotuner on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_jit_server_on_card(cuda_device):
    """``mode="jit"`` on forge-125m smoke (f32): the step compiled whole
    and replayed as one CUDA graph.  Greedy tokens equal the interpret
    server's, fused-linear launches = the graph's kernel nodes x steps
    (recorded at capture, added at each replay), no other kernel, one
    graph built in warmup, and the cache's storage never moves."""
    from torch.utils import _pytree as pytree

    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    want = BatchedServer(cfg, p, max_len=32, mode="interpret").generate(prompts, 4)
    srv = BatchedServer(cfg, p, max_len=32, mode="jit")
    srv.warmup([3])
    step = srv.jit_steps[3]
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(step.cache)]
    for mod in (FL, FA, PA):
        mod.LAUNCHES.reset()
    got = srv.generate(prompts, 4)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert step.graphs == 1 and step._replay is not None and got["compile_s"] == 0.0
    assert FL.LAUNCHES.n == step.kernel_nodes["fused_linear"] * (6 + 4 - 1) > 0
    assert FA.LAUNCHES.n == PA.LAUNCHES.n == 0
    assert [t.data_ptr() for t in pytree.tree_leaves(step.cache)] == ptrs


@pytest.mark.cuda
def test_autotuner_compile_on_card(cuda_device):
    """``AutotuningCompiler().compile`` on forge-125m smoke's block body
    at S=64 (unmasked causal attention): 47 candidates, and the winner
    runs its kernels (one flash, three fused-linear launches) within the
    f32 tolerance of the raw body."""
    from repro_torch.core import AutotuningCompiler
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    p = get_model(cfg).init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(1))
    x = L.embed(tokens, p["embed"])
    cos, sin = T._rope_for(cfg, torch.arange(64, device=cuda_device))
    args = (p["blocks"][0], x, cos, sin)

    def body(*a):
        return T.block_apply(*a, cfg=cfg)

    mod = AutotuningCompiler().compile(body, *args)
    assert len(mod.tune_result.candidates) == 47
    FL.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    got = mod(*args)
    torch.cuda.synchronize()
    assert FA.LAUNCHES.n == 1 and FL.LAUNCHES.n == 3
    torch.testing.assert_close(got, body(*args), **TOL_F32)


# --------------------------------------------------------------------------
# the MoE and VLM families: phi3.5-moe, kimi-k2 and qwen2-vl-72b smoke
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D,S", [(64, 128, 300), (64, 112, 256), (32, 128, 256)])
def test_flash_gqa8_and_d112(cuda_device, dtype, H, D, S):
    """Flash at the new models' apply shapes: 64 query heads on 8 KV heads
    (qwen2-vl-72b, kimi-k2's D=112 padded to 128) and phi3.5-moe's 32 on 8."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(H + D, 1, H, 8, S, S, D))
    got = FA.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=True)
    if dtype == torch.bfloat16:
        assert FA.variant(q, k, v) == "wgmma"
        _assert_flash_bf16(got, q, k, v, D ** -0.5, True)
    else:
        want = FA.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=True)
        torch.testing.assert_close(got, want, **TOL_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "qwen2-vl-72b"])
def test_moe_vlm_apply_on_card_matches_plain(cuda_device, arch):
    """``apply`` (the VLM with 4 patch embeddings) through the kernels,
    within the f32 tolerance of ``impl="ref"``; flash once a layer."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 12), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    kw = ({"patch_embeds": torch.randn(2, 4, cfg.d_model, device=cuda_device) * 0.02}
          if cfg.family == "vlm" else {})
    _reset_counts()
    got = m.apply(p, toks, cfg, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES.n == cfg.n_layers and FL.LAUNCHES.n > 0
    torch.testing.assert_close(got, m.apply(p, toks, cfg, impl="ref", **kw), **TOL_F32)


@pytest.mark.cuda
def test_moe_paged_scheduler_on_card(cuda_device):
    """phi3.5-moe smoke (f32) through the paged ``SlotScheduler`` with the
    paged kernel: every request served, the sequential fill through the
    decode program (no prefill dispatch), paged launches = layers x decode
    dispatches, and the same tokens under segment_jit and interpret."""
    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True).with_(dtype="float32",
                                                               kv_kernel="pallas")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    runs = {}
    for backend in ("interpret", "segment_jit"):
        srv = BatchedServer(cfg, p, max_len=32, mode="forge", backend=backend, paged=True,
                            kv_page_size=8, seq_bucket_policy="ladder:8,16,32")
        sched = SlotScheduler(srv, max_slots=4)
        sched.warmup(prompt_lens=[4, 8, 16, 24])
        _reset_counts()
        res = sched.run(paged_workload(Request, cfg.vocab))
        torch.cuda.synchronize()
        assert res["prefill_dispatches"] == 0 and srv.prefill_bucketed is None
        assert PA.LAUNCHES.n == cfg.n_layers * res["decode_dispatches"] > 0
        srv.page_pool.check()
        assert srv.page_pool.pages_in_use == 1
        runs[backend] = {rid: r["tokens"] for rid, r in res["results"].items()}
    assert runs["segment_jit"].keys() == runs["interpret"].keys()
    for rid, toks in runs["interpret"].items():
        np.testing.assert_array_equal(runs["segment_jit"][rid], toks)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"])
def test_moe_vlm_jit_server_on_card(cuda_device, arch):
    """``mode="jit"`` on the MoE and VLM smoke configs (f32): one graph, the
    interpret server's greedy tokens."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    m = get_model(cfg)
    p = m.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    want = BatchedServer(cfg, p, max_len=32, mode="interpret").generate(prompts, 4)
    srv = BatchedServer(cfg, p, max_len=32, mode="jit")
    got = srv.generate(prompts, 4)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert srv.jit_steps[3].graphs == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk", [(2, 300, 300), (2, 100, 260), (2, 260, 100), (4, 1, 500)])
def test_flash_encdec_noncausal(cuda_device, dtype, B, Sq, Sk):
    """Flash without a mask at the encoder-decoder family's shapes (16
    heads of 64): the encoder's Sq = Sk, cross-attention with fewer and
    with more queries than keys (ragged tiles of both), and the decode
    step's single query row against the encoder frames."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(Sq + Sk, B, 16, 16, Sq, Sk, 64))
    got = FA.flash_attention_cuda(q, k, v, scale=0.125, causal=False)
    if dtype == torch.bfloat16:
        assert FA.variant(q, k, v) == "wgmma"
        _assert_flash_bf16(got, q, k, v, 0.125, False)
    else:
        want = FA.flash_attention_plain(q, k, v, scale=0.125, causal=False)
        torch.testing.assert_close(got, want, **TOL_F32)


@pytest.mark.cuda
def test_encdec_compiled_step_on_card(cuda_device):
    """seamless-m4t-large-v2 smoke (f32): the serve step compiled whole,
    on segment_jit bitwise equal to interpret over 6 greedy steps (tokens,
    logits, cache), within the f32 tolerance of the eager step (which runs
    no kernel); each step launches flash once a decoder layer (the
    cross-attention at one query row) and four fused linears a layer."""
    from repro_torch.core import ForgeCompiler
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import encdec

    cfg = get_config("seamless-m4t-large-v2", smoke=True).with_(dtype="float32")
    p = encdec.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    frames = torch.randn(2, 37, cfg.d_model, device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    cache = encdec.init_cache(p, frames, cfg, 16)
    step = make_serve_step(cfg, logits=True)
    tok = torch.tensor([[3], [5]], device=cuda_device)
    pos = torch.tensor(0, device=cuda_device)
    seg = ForgeCompiler(backend="segment_jit").compile(step, p, cache, tok, pos,
                                                       static_argnums=(0,))
    interp = seg.with_backend("interpret")
    caches = {"seg": cache, "interp": cache, "eager": cache}
    for i in range(6):
        pos = torch.tensor(i, device=cuda_device)
        _reset_counts()
        got = seg(p, caches["seg"], tok, pos)
        torch.cuda.synchronize()
        assert FA.LAUNCHES.n == cfg.n_dec_layers and FL.LAUNCHES.n == 4 * cfg.n_dec_layers
        want = interp(p, caches["interp"], tok, pos)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(g, w)
        eager = step(p, caches["eager"], tok, pos)
        torch.testing.assert_close(got[2], eager[2], **TOL_F32)
        caches = {"seg": got[1], "interp": want[1], "eager": eager[1]}
        tok = got[0].long()


def _grads(fn, inputs, gout):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, gout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,bias", [("gelu", True), ("silu", False)])
def test_fused_linear_grad_on_card(cuda_device, dtype, act, bias):
    """The gradient through the fused-linear custom op (the kernel
    forward at the training step's M = 1024, the registered plain
    backward) against autograd through the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    M, K, N = 1024, 768, 3072
    x = (torch.randn(M, K, generator=g, device=cuda_device) * 0.5).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5).to(dtype)
    ins = [x, w] + ([torch.randn(N, generator=g, device=cuda_device).to(dtype) * 0.1]
                    if bias else [])
    gy = torch.randn(M, N, generator=g, device=cuda_device).to(dtype)
    FL.LAUNCHES.reset()
    got = _grads(lambda x, w, *b: FL.fused_linear(x, w, *b, act=act), ins, gy)
    torch.cuda.synchronize()
    assert FL.LAUNCHES.n == 1
    want = _grads(lambda x, w, *b: FL.fused_linear_plain(x, w, *b, act=act), ins, gy)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grad_on_card(cuda_device, dtype):
    """The gradient through the flash custom op at the training shape
    (causal B8 H12 S128 D64) against autograd through the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(22, 8, 12, 12, 128, 128, 64))
    go = torch.randn(8, 12, 128, 64, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(3)).to(dtype)
    FA.LAUNCHES.reset()
    got = _grads(lambda q, k, v: FA.flash_attention(q, k, v, scale=0.125, causal=True),
                 [q, k, v], go)
    torch.cuda.synchronize()
    assert FA.LAUNCHES.n == 1
    want = _grads(lambda q, k, v: FA.flash_attention_plain(q, k, v, scale=0.125, causal=True),
                  [q, k, v], go)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
def test_rg_lru_grad_on_card(cuda_device):
    """The gradient through the RG-LRU scan's custom op (B2 T128 D2560
    f32) against autograd through the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    B, T, D = 2, 128, 2560
    x = torch.randn(B, T, D, generator=g, device=cuda_device)
    a = torch.rand(B, T, D, generator=g, device=cuda_device) * 0.699 + 0.3
    h0 = torch.randn(B, D, generator=g, device=cuda_device)
    gh = torch.randn(B, T, D, generator=g, device=cuda_device)
    RG.LAUNCHES.reset()
    got = _grads(RG.rg_lru, [x, a, h0], gh)
    torch.cuda.synchronize()
    assert RG.LAUNCHES.n == 1
    want = _grads(RG.rg_lru_plain, [x, a, h0], gh)
    for a_, b_ in zip(got, want):
        torch.testing.assert_close(a_, b_, **TOL_F32)


@pytest.mark.cuda
def test_train_step_on_card(cuda_device):
    """Two train steps of forge-125m's layout (3 layers, full width, bf16,
    remat) on the card: each step launches flash and fused linear in
    every block body twice (the forward and the rerun in backward), the
    loss is finite, and the step's gradients match impl="ref"'s within
    the bf16 model tolerance by relative L2."""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW

    cfg = get_config("forge-125m").with_(n_layers=3)
    assert cfg.remat
    params = get_model(cfg).init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                 cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (8, 129), generator=g, device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW()
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    losses = []
    for _ in range(2):
        _reset_counts()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert FA.LAUNCHES.n == 2 * cfg.n_layers and FL.LAUNCHES.n == 6 * cfg.n_layers
        assert FA.LAUNCHES.variants == {"wgmma": 2 * cfg.n_layers}
    assert all(np.isfinite(losses)) and int(state.step) == 2
    _, got = steps.loss_and_grads(steps.make_loss_fn(cfg), params, batch)
    _, want = steps.loss_and_grads(steps.make_loss_fn(cfg, impl="ref"), params, batch)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel < 0.1, rel


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A one-rank NCCL group on the card and its (1, 1) host mesh; the
    group is destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/nccl", rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_planned_apply_and_step_on_card(cuda_device, nccl_mesh):
    """forge-125m's layout (3 layers, full width, bf16) placed by
    ``plan_for`` as DTensors on a one-rank NCCL mesh: ``apply`` and a
    train step launch what the unplanned run launches, with logits and
    loss bitwise the unplanned run's."""
    from torch.utils import _pytree as pytree

    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW

    cfg = get_config("forge-125m").with_(n_layers=3)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    plan = plan_for(cfg, nccl_mesh)
    dparams = distribute_tree(params, plan.params_shardings(params))
    toks = torch.randint(0, cfg.vocab, (2, 257), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    with torch.no_grad():
        want = model.apply(params, toks[:, :-1], cfg)
        _reset_counts()
        with replicate_plain():
            got = model.apply(dparams, distribute_tree(toks[:, :-1], plan.batch_shardings(
                toks[:, :-1])), cfg)
        torch.cuda.synchronize()
    assert FA.LAUNCHES.n == cfg.n_layers and FL.LAUNCHES.n == 3 * cfg.n_layers
    assert torch.equal(got.full_tensor(), want)

    opt = AdamW()
    state = opt.init(params)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    step = steps.make_train_step(cfg, opt)
    _, _, m1 = step(params, state, batch)
    dstate = distribute_tree(state, plan.opt_state_shardings(state, params))
    dbatch = distribute_tree(batch, plan.batch_shardings(batch))
    _reset_counts()
    with replicate_plain():
        p2, _, m2 = step(dparams, dstate, dbatch)
        loss = m2["loss"].full_tensor()
    torch.cuda.synchronize()
    assert FA.LAUNCHES.n == 2 * cfg.n_layers and FL.LAUNCHES.n == 6 * cfg.n_layers
    assert torch.equal(loss, m1["loss"])
    assert all(t.placements == (torch.distributed.tensor.Replicate(),) * 2
               for t in pytree.tree_leaves(p2))


@pytest.mark.cuda
def test_compressed_all_reduce_on_card(cuda_device, nccl_mesh):
    """``compressed_all_reduce`` on the one-rank NCCL group: every
    256-element block within its amax / 254 of the plain ``all_reduce``;
    the int8 codes and the scales bitwise the CPU computation's (the
    scale is an IEEE division of two tensors on both)."""
    import torch.distributed as dist

    from repro_torch.runtime import compressed_all_reduce, quantize_int8
    from repro_torch.runtime.compress import BLOCK

    g = torch.Generator(device=cuda_device).manual_seed(2)
    for n in (256, 1000, 768 * 3072 + 5):
        x = torch.randn(n, device=cuda_device, generator=g) * 3.0
        got = compressed_all_reduce(x)
        want = x.clone()
        dist.all_reduce(want)
        _, scale, _ = quantize_int8(x)
        err = torch.nn.functional.pad(got - want, (0, (-n) % BLOCK)).reshape(-1, BLOCK).abs()
        assert bool((err <= scale * 127.0 / 254 * (1 + 2.0 ** -12)).all())
        q, s, _ = quantize_int8(x)
        q_cpu, s_cpu, _ = quantize_int8(x.cpu())
        assert torch.equal(q.cpu(), q_cpu)
        assert torch.equal(s.cpu(), s_cpu)
