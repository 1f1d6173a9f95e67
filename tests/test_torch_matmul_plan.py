"""The launch plan of the port's SplitQuant matmul (pure Python, no card):
for every quantized matrix that stablelm-1.6b's and paligemma-3b's
engines, rwkv6-3b's and recurrentgemma-9b's wave loops and whisper-tiny
(also at its encoder's 12000 rows) multiply by (paligemma-3b's patch
projection at K = 1152, its geglu at N = 16384; its tied head is a plain
product), at the row counts of a decode step (8), a prompt chunk (96)
and a wave prefill or 8 x 256 patch rows (2048), the tiles and K splits
cover the product exactly, the dtype picks the variant, and a grid that
would underfill the card's 132 SMs is split along K; a product of more
than 2^31 - 1 outputs is launched in slabs of rows."""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.transformer import VLM_PATCH_DIM
from repro_torch.kernels.splitquant_matmul import (CUDA_CORE, MAX_OUTPUTS,
                                                   TENSOR_CORE,
                                                   blocks_per_sm, plan,
                                                   row_slabs)

SMS = 132                                   # H100 SXM


def _shapes(arch):
    """(K, N) of every SplitQuant matrix of the arch's serving path."""
    cfg = get_arch(arch)
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    if cfg.family == "ssm":                 # time mix r k v g o, channel mix
        return sorted({(d, d), (d, ff), (ff, d), (d, v)})
    hd = d // cfg.n_heads
    out = {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d), (d, ff), (ff, d)}
    if not cfg.tie_embeddings:
        out.add((d, v))
    if cfg.family == "vlm":                 # the patch projection
        out.add((VLM_PATCH_DIM, d))
    if cfg.family == "hybrid":              # griffin's recurrent branch
        out |= {(d, cfg.lru_width), (cfg.lru_width, d)}
    return sorted(out)


ARCHS = ("stablelm-1.6b", "rwkv6-3b", "paligemma-3b", "recurrentgemma-9b",
         "whisper-tiny")
CASES = [(arch, K, N, M) for arch in ARCHS
         for K, N in _shapes(arch) for M in (8, 96, 2048)] + \
    [("whisper-tiny", K, N, 12000) for K, N in _shapes("whisper-tiny")]


def test_main_path_shapes():
    assert _shapes("stablelm-1.6b") == [(2048, 2048), (2048, 5632),
                                        (2048, 100352), (5632, 2048)]
    assert _shapes("rwkv6-3b") == [(2560, 2560), (2560, 8960),
                                   (2560, 65536), (8960, 2560)]
    assert _shapes("paligemma-3b") == [(1152, 2048), (2048, 256),
                                       (2048, 2048), (2048, 16384),
                                       (16384, 2048)]


def test_griffin_and_whisper_shapes():
    """recurrentgemma-9b's products (its MQA wk / wv at N = 256, the
    RG-LRU branch, geglu, the 256000-wide head; the conv taps are read
    dequantized, not multiplied) and whisper-tiny's (its head is tied)."""
    assert _shapes("recurrentgemma-9b") == [(4096, 256), (4096, 4096),
                                            (4096, 12288), (4096, 256000),
                                            (12288, 4096)]
    assert _shapes("whisper-tiny") == [(384, 384), (384, 1536),
                                       (1536, 384)]


@pytest.mark.parametrize("M,N", [(8, 256000), (8388, 256000),
                                 (8389, 256000), (9600, 256000),
                                 (12000, 384), (3, 2 ** 31), (1, 1)])
def test_row_slabs_keep_each_launch_under_the_int32_outputs(M, N):
    """The kernel indexes at most 2^31 - 1 outputs a launch: a larger
    product (griffin_ring's 4 x 2400-row prefill times the 256000-wide
    head) runs in slabs of whole rows that tile [0, M) in order; a
    smaller one in one launch."""
    slabs = row_slabs(M, N)
    assert slabs[0][0] == 0 and slabs[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert all(r1 > r0 and ((r1 - r0) * N <= MAX_OUTPUTS or r1 - r0 == 1)
               for r0, r1 in slabs)
    assert (len(slabs) == 1) == (M * N <= MAX_OUTPUTS)
    assert len(slabs) == -(-M // max(1, MAX_OUTPUTS // N))


@pytest.mark.parametrize("M", [8, 2048])
def test_patch_projection_plan_at_k_1152(M):
    """K = 1152 (18 tiles of 64, not a power of two): the K slices are
    whole tiles that end on packed bytes at INT2, INT4 and INT8 and tile
    K exactly, none empty (8 rows: 18 slices of one tile; 8 x 256 patch
    rows: 2 of 9)."""
    p = plan(M, 1152, 2048, torch.bfloat16, SMS)
    assert p.k_per_split % p.bk == 0 and 1152 % p.k_per_split == 0
    assert all((p.k_per_split * bits) % 8 == 0 for bits in (2, 4, 8))
    assert p.splits * p.k_per_split == 1152
    assert (p.splits, p.k_per_split) == ((18, 64) if M == 8 else (2, 576))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch,K,N,M", CASES)
def test_plan_covers_the_product(arch, K, N, M, dtype, bits):
    p = plan(M, K, N, dtype, SMS)
    assert p.variant == (TENSOR_CORE if dtype == torch.bfloat16
                         else CUDA_CORE)
    if dtype == torch.bfloat16:
        assert p.bm == (64 if M <= 64 else 128)
    else:
        assert p.bm == 8
    assert (p.bn, p.bk) == (128, 64)
    assert p.k_per_split % p.bk == 0
    # the K slices tile [0, K) exactly, none empty
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
    # the row and column tiles cover M and N, the last one not empty
    for size, tile in ((M, p.bm), (N, p.bn)):
        n = -(-size // tile)
        assert (n - 1) * tile < size <= n * tile
    blocks = -(-M // p.bm) * -(-N // p.bn)
    tiles = -(-K // p.bk)
    if blocks < SMS and tiles > 1:
        assert p.splits > 1                 # an underfilled grid is split
    target = blocks_per_sm(p.variant, M) * SMS
    if blocks >= target:
        assert p.splits == 1                # a full grid is not
    else:                                   # nor split past its target
        assert (p.splits - 1) * blocks < target
    # the code bytes of a K slice start on a packed-byte boundary
    assert (p.k_per_split * bits) % 8 == 0


@pytest.mark.parametrize("M,K,N", [(1, 64, 4), (13, 200, 130), (65, 200, 130),
                                   (2048, 200, 130), (8, 4, 1)])
def test_plan_of_ragged_shapes(M, K, N):
    for dtype in (torch.bfloat16, torch.float32):
        p = plan(M, K, N, dtype, SMS)
        assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split


def test_card_tests_cover_both_tiles_with_and_without_splits():
    from test_torch_cuda import MATMUL_SHAPES
    seen = {(p.bm, p.splits > 1) for p in
            (plan(M, K, N, torch.bfloat16, SMS) for M, K, N in MATMUL_SHAPES)}
    assert seen == {(64, False), (64, True), (128, False), (128, True)}


def test_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        plan(8, 64, 64, torch.float16, SMS)
