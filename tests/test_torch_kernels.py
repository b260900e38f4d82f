"""The port's CUDA flat-scan kernel (K1, K2) against its plain PyTorch version, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips elsewhere.  This file imports no jax (the card's machine has none);
run it there without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Limits: fp32 scores within 1e-4 of the plain version (bf16 x bf16 products
are exact in fp32; only the summation order differs); bf16 stored scores
within one bf16 ulp of the value, or 1e-4 near zero, where the fp32
summation-order error exceeds a bf16 ulp.
"""

import numpy as np
import pytest
import torch

from colbert_tpu_torch.ops import flat_scan as fs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


def _case(device, num_docs, dv, h, B, m, dtype, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(num_docs * dv, h)).astype(np.float16) / np.sqrt(h)
    table, inv, dv = fs.build_flat_table(emb, np.full(num_docs, dv), dtype=dtype)
    Qm = rng.normal(size=(B, m, h)).astype(np.float32) / np.sqrt(h)
    Qm[0, m // 2 :] = 0.0  # masked views
    Qm = torch.from_numpy(Qm)
    if inv is not None:
        Qm = Qm * inv
    return table.to(device), Qm.to(device), dv


def _bf16_limit(a, b):
    """One bf16 ulp (8 significant bits) at the larger of |a|, |b|, at least 1e-4."""
    ax = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(ax)
    return torch.ldexp(torch.ones_like(ax), e - 8).clamp_min(1e-4)


# (num_docs, dv, h, B, m, table dtype): multiview shapes, a ragged last group,
# an int8 table, a partial query tile and a short hidden dim
CASES = [
    (2000, 16, 768, 144, 16, "bfloat16"),
    (301, 37, 768, 20, 16, "bfloat16"),
    (997, 16, 768, 33, 16, "int8"),
    (150, 5, 128, 7, 32, "bfloat16"),
]


@pytest.mark.parametrize("num_docs,dv,h,B,m,dtype", CASES)
def test_kernels_match_plain(cuda_device, num_docs, dv, h, B, m, dtype):
    table, Qm, dv = _case(cuda_device, num_docs, dv, h, B, m, dtype, seed=num_docs)
    want = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)
    got = fs.flat_maxsim_scan(Qm, table, dv=dv)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs - 3, score_dtype="float32")
    rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs - 3, score_dtype="float32")
    torch.testing.assert_close(s, rs, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-4)

    s, g = fs.flat_scan_fused(Qm, table, dv=dv, num_docs=num_docs - 3, score_dtype="bfloat16")
    rs, rg = fs.flat_scan_fused_ref(Qm, table, dv=dv, num_docs=num_docs - 3, score_dtype="bfloat16")
    assert s.dtype == torch.bfloat16
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert ((s.float() - rs.float())[fin].abs() <= _bf16_limit(s, rs)[fin]).all()
    assert ((g - rg).abs() <= _bf16_limit(g, rg)).all()


def test_topk_on_card_matches_plain(cuda_device):
    table, Qm, dv = _case(cuda_device, 1500, 16, 768, 144, 16, "bfloat16", seed=9)
    k1_before = fs.flat_scan_fused.launches.value
    ts, tp = fs.flat_scan_topk(Qm, table, dv=dv, num_docs=1490, topk=100, score_dtype="float32")
    assert fs.flat_scan_fused.launches.value == k1_before + 1
    full = fs.flat_maxsim_scan_ref(Qm, table, dv=dv)[:1490].T
    want, _ = torch.topk(full, 100, dim=1)
    torch.testing.assert_close(ts, want, rtol=0, atol=1e-4)
    assert ((tp >= 0) & (tp < 1490)).all()
    torch.testing.assert_close(full.gather(1, tp.long()), ts, rtol=0, atol=1e-4)


def test_queries_off_16_byte_alignment(cuda_device):
    """A bf16 query view that starts mid-allocation is copied, not misread."""
    table, Qm, dv = _case(cuda_device, 200, 16, 128, 9, 16, "bfloat16", seed=3)
    flat = torch.empty(Qm.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    view = flat[1:].view(Qm.shape)
    view.copy_(Qm)
    assert view.data_ptr() % 16
    torch.testing.assert_close(fs.flat_maxsim_scan(view, table, dv=dv),
                               fs.flat_maxsim_scan_ref(view, table, dv=dv), rtol=0, atol=1e-4)


def test_kernel_rejects_unsupported_shapes(cuda_device):
    table = torch.zeros(64, 24, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        fs.flat_maxsim_scan(torch.zeros(2, 4, 24, device=cuda_device), table, dv=4)
    table = torch.zeros(64, 32, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="bf16 or int8"):
        fs.flat_maxsim_scan(torch.zeros(2, 4, 32, device=cuda_device), table, dv=4)
