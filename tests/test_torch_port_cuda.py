"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Skips without a CUDA device (the kernels have no CPU mode). This file imports
no JAX, so it also runs on a GPU machine without JAX, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

fp32 comparisons run with TF32 off; bf16 ones allow 1 bf16 ulp (rtol 1e-2).
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.kernels import conv3x3, corr_fused, corr_lookup_v2, corr_plane, norm
from flow_supervisor_tpu_torch.ops.corr import window_support

R = 4


def _lookup_inputs(b, h8, w8, c, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h8, w8, c)).astype(np.float32)
    coords = np.stack(
        [rng.uniform(-15, w8 + 15, (b, h8, w8)), rng.uniform(-15, h8 + 15, (b, h8, w8))], -1
    ).astype(np.float32)
    return f1, f2, coords


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1_matches_plain(cuda, dtype):
    f1, f2, coords = _lookup_inputs(b=2, h8=5, w8=9, c=64, seed=9)
    planes = corr_plane.build_plane_pyramid(
        torch.from_numpy(f1).to(cuda), torch.from_numpy(f2).to(cuda), 4, dtype
    )
    c = torch.from_numpy(coords).reshape(-1, 2).to(cuda)
    got = corr_plane.corr_lookup(planes, c, R, dtype).float()
    want = corr_plane.corr_lookup_plain(planes, c, R, torch.float32)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 40, 64, 64), (1, 11, 90, 128, 128)])
def test_cuda_k2_matches_plain(cuda, dtype, shape):
    b, h, w, c, co = shape
    g = torch.Generator().manual_seed(10)
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
    k = (0.1 * torch.randn(3, 3, c, co, generator=g)).to(cuda, dtype)
    bias = (0.1 * torch.randn(co, generator=g)).to(cuda, dtype)
    y, st = conv3x3.conv3x3_stats(x, k, bias)
    y_ref, st_ref = conv3x3.conv3x3_stats_plain(x, k, bias)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_cuda_k3_k4_match_plain(cuda, dtype, relu):
    g = torch.Generator().manual_seed(11)
    x = (3 * torch.randn(2, 37, 50, 96, generator=g) + 1.5).to(cuda, dtype)
    st = norm.instance_norm_stats(x)
    st_ref = norm.instance_norm_stats_plain(x)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=1e-5)
    y = norm.instance_norm_apply(x, st_ref, relu)
    y_ref = norm.instance_norm_apply_plain(x, st_ref, relu)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)


def _fused_inputs(b, c, dtype, dev, seed):
    f1, f2, coords = _lookup_inputs(b=b, h8=7, w8=11, c=c, seed=seed)
    coords[0, 0, 0] = (1e9, -1e9)  # far out of bounds: reads 0, no overflow
    pyr = corr_fused.build_fused_pyramid(
        torch.from_numpy(f1).to(dev, dtype), torch.from_numpy(f2).to(dev, dtype), 4
    )
    return pyr, torch.from_numpy(coords).reshape(-1, 2).to(dev)


# C=64: 16-byte loads; C=36: the scalar path (C % 8 != 0); C=320: two 256-channel chunks
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 36, 320])
def test_cuda_k6_matches_plain(cuda, dtype, c):
    pyr, coords = _fused_inputs(1, c, dtype, cuda, 12)
    got = corr_fused.corr_fused_all(pyr.f1, pyr.f2s, coords, R, dtype).float()
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    # fp32: only the summation order of C products differs
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 36, 320])
def test_cuda_k7_matches_plain(cuda, dtype, c):
    pyr, coords = _fused_inputs(2, c, dtype, cuda, 13)
    k2 = (2 * R + 1) ** 2
    got = torch.full((coords.shape[0], 4 * k2), float("nan"), device=cuda, dtype=dtype)
    for lvl, f2 in enumerate(pyr.f2s):
        corr_fused.corr_fused_level(pyr.f1, f2, lvl, coords, R, got)
    want = corr_fused.corr_fused_plain(pyr.f1, pyr.f2s, coords, R, torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k10_matches_plain(cuda, dtype):
    f1, f2, coords = _lookup_inputs(b=2, h8=5, w8=9, c=64, seed=14)
    planes = corr_plane.build_plane_pyramid(
        torch.from_numpy(f1).to(cuda), torch.from_numpy(f2).to(cuda), 4, dtype
    )
    c = torch.from_numpy(coords).reshape(-1, 2).to(cuda)
    c[0] = torch.tensor([-3e38, 3e38])
    for lvl, plane in enumerate(planes):
        cl = (c / 2.0 ** lvl).contiguous()
        got = corr_lookup_v2.level_support(plane, cl, R)
        # a copy of plane values (bf16 -> fp32 is exact): equal
        torch.testing.assert_close(got, window_support(plane, cl, R), atol=0, rtol=0)
