"""The conv3x3 kernel's body choice (K2 / K5, csrc/conv3x3.cu) and its
profiler category, on the CPU: which convs the tensor-core body takes, and
that ``profile_forward`` books every kernel symbol of the conv source under
K2 / K5 and not under cuDNN (whose keys match "conv")."""
import os
import re

import pytest
import torch

from flow_supervisor_tpu_torch.kernels import conv3x3
from flow_supervisor_tpu_torch.profile_forward import _category

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "flow_supervisor_tpu_torch", "csrc", "conv3x3.cu")
K2_CATEGORY = "K2 conv3x3_stats / K5 conv3x3"


def _pair(c, cout, dtype=torch.bfloat16):
    return torch.zeros(1, 4, 5, c, dtype=dtype), torch.zeros(3, 3, c, cout, dtype=dtype)


@pytest.mark.parametrize("c,cout", [(64, 64), (96, 96), (128, 128), (96, 72), (16, 8), (128, 40)])
def test_bf16_model_widths_take_the_tensor_core_body(c, cout):
    assert conv3x3.tensor_core_body(*_pair(c, cout))


@pytest.mark.parametrize("c,cout,dtype", [
    (64, 64, torch.float32),    # fp32 keeps full fp32 products
    (128, 128, torch.float32),
    (8, 64, torch.bfloat16),    # C % 16 != 0
    (40, 64, torch.bfloat16),
    (64, 60, torch.bfloat16),   # Cout % 8 != 0
    (64, 136, torch.bfloat16),  # Cout > 128: no single wgmma width covers it
    (144, 64, torch.bfloat16),  # C > 128: a block's weights and slabs do not fit
])
def test_other_convs_take_the_cuda_core_body(c, cout, dtype):
    assert not conv3x3.tensor_core_body(*_pair(c, cout, dtype))


def test_misaligned_input_takes_the_cuda_core_body():
    x, w = _pair(64, 64)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    shifted = flat[1:].view(x.shape)  # 2 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16 != 0
    assert not conv3x3.tensor_core_body(shifted, w)
    assert conv3x3.tensor_core_body(x, w)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w = _pair(64, 64)
    before = (conv3x3.launches, conv3x3.bare_launches, conv3x3.tc_launches)
    conv3x3.conv3x3_stats(x, w, torch.zeros(64, dtype=x.dtype))
    conv3x3.conv3x3_fused(x, w, torch.zeros(64, dtype=x.dtype))
    assert (conv3x3.launches, conv3x3.bare_launches, conv3x3.tc_launches) == before


def _kernel_symbols():
    with open(SRC) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names, "no __global__ kernel found in conv3x3.cu"
    return sorted(set(names))


@pytest.mark.parametrize("name", _kernel_symbols())
def test_profiler_books_conv_kernels_under_k2(name):
    # how the profiler names a template kernel: demangled, and mangled
    demangled = f"void (anonymous namespace)::{name}<64, true, false>(__nv_bfloat16 const*)"
    mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi64ELb1ELb0EEEvPK13__nv_bfloat16"
    assert _category(demangled) == K2_CATEGORY
    assert _category(mangled) == K2_CATEGORY


def test_profiler_still_books_cudnn_convs_as_cudnn():
    assert _category("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc") == "cuDNN conv"
