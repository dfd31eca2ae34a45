"""The port's CUDA kernels on the card: each against its plain PyTorch
version in bf16, and a tiny region-QA ``generate`` through all three.

Every test here is marked ``gpu`` and skips where there is no CUDA card
(the kernels are CUDA C++ for sm_90a and have no CPU mode).  The file
imports no jax, so it also runs where the JAX package's test conftest
cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from spatialrgpt_tpu.config import (
    LlamaConfig,
    ProjectorConfig,
    RegionExtractorConfig,
    SiglipVisionConfig,
    SpatialRGPTConfig,
)
from spatialrgpt_tpu.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu.data.splice import expand_rows
from spatialrgpt_tpu_torch.models.vlm import VLMInputs
from spatialrgpt_tpu_torch.ops import decode_attention as K3
from spatialrgpt_tpu_torch.ops import prefill_attention as K2
from spatialrgpt_tpu_torch.ops import vit_attention as K1
from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound
from spatialrgpt_tpu_torch.serving.generate import generate
from spatialrgpt_tpu_torch.utils.weights import init_random

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, device):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(device, torch.bfloat16)


def _bf16_close(out, ref):
    # the kernel rounds P to bf16 at other running maxima (K3 keeps it in
    # fp32) and sums in another order: 4 bf16 ulps of each element plus of
    # its row's largest value (tests/test_torch_kernels.py shows that this
    # bound rejects a kernel that skips one key tile)
    ratio = bf16_err_over_bound(out, ref)
    assert ratio <= 1.0, ratio


def test_vit_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    for S, valid_len in ((729, None), (256, 200), (5, None)):
        q, k, v = (_rand(rng, 3, S, 4, 72, device=cuda) for _ in range(3))
        before = K1.launches
        out = K1.vit_attention(q, k, v, valid_len=valid_len)
        torch.cuda.synchronize()
        assert K1.launches == before + 1
        _bf16_close(out, K1.vit_attention_plain(q, k, v, valid_len=valid_len))


def test_vit_kernel_reads_strided_heads(cuda):
    """q/k/v as views into a fused (B, S, 3, H, D) projection: the kernel
    reads through strides, no copy."""
    qkv = _rand(np.random.default_rng(1), 2, 100, 3, 4, 72, device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _bf16_close(K1.vit_attention(q, k, v), K1.vit_attention_plain(q, k, v))


def test_onepass_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    for hq, hk, S, window in ((32, 8, 320, None), (4, 4, 100, None), (8, 2, 200, 37), (8, 1, 70, None)):
        q = _rand(rng, 3, S, hq, 128, device=cuda)
        k, v = (_rand(rng, 3, S, hk, 128, device=cuda) for _ in range(2))
        seg = torch.ones(3, S, dtype=torch.int32, device=cuda)
        seg[1, S // 2 :] = 0  # right padding
        seg[2, S // 3 :] = 2  # two packed segments
        before = K2.launches
        out = K2.onepass_attention(q, k, v, seg, window=window)
        torch.cuda.synchronize()
        assert K2.launches == before + 1
        assert torch.all(out[1, S // 2 :] == 0)
        _bf16_close(out, K2.onepass_attention_plain(q, k, v, seg, window=window))


def test_decode_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    for B, C, Hq, Hk, D in ((4, 352, 32, 8, 128), (3, 17, 4, 2, 8), (2, 1000, 8, 8, 64)):
        q = _rand(rng, B, Hq, D, device=cuda)
        kq = torch.tensor(rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8), device=cuda)
        vq = torch.tensor(rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8), device=cuda)
        ks = torch.tensor(rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32), device=cuda)
        vs = torch.tensor(rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32), device=cuda)
        lengths = torch.tensor(([0, C - 1] + list(rng.integers(0, C, B)))[:B], dtype=torch.int32, device=cuda)
        before = K3.launches
        out = K3.decode_attention_int8_flat(q, kq, ks, vq, vs, lengths, Hk)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        _bf16_close(out, K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths, Hk))


def test_tiny_generate_runs_the_three_kernels(cuda):
    """A tiny region-QA batch on the card: the kernel path launches K1 once
    per tower layer, K2 once per decoder layer and K3 once per decoder
    layer and decode step, and its first-token logits agree with the plain
    path's."""
    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, eos_token_id=63),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )
    sb = expand_rows(
        [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)],
        None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2, pad_to=12,
    )
    rng = np.random.default_rng(4)
    inputs = VLMInputs.from_spliced(
        sb, rng.standard_normal((2, 56, 56, 3)), rng.standard_normal((2, 56, 56, 3)),
        (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((2, 2), bool),
        device=cuda, dtype=torch.bfloat16,
    )
    plens = torch.as_tensor(sb.segment_ids.sum(axis=1), device=cuda)
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    for m in (K1, K2, K3):
        m.launches = 0
    fast = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="onepass")
    assert (K1.launches, K2.launches, K3.launches) == (2, 2, 2 * 4)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="xla")
    assert (K1.launches, K2.launches, K3.launches) == (2, 2, 2 * 4)
    assert fast.tokens.shape == (2, 5) and ((fast.tokens >= 0) & (fast.tokens < 64)).all()
    rel = (fast.first_logits - plain.first_logits).norm() / plain.first_logits.norm()
    assert float(rel) < 0.05
