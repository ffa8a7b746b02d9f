"""Lower precisions for the benchmark's controls: the reference computed a
step below the precision a configuration states, which the correctness
check has to refuse.

- ``fp8``: the operands of every conv and matrix product rounded to
  float8 e4m3 with a per-tensor scale (the tensor's largest magnitude onto
  448, e4m3's largest finite value), products and sums in float32; the
  gradient passes the rounding unchanged. The step below bfloat16.
- TF32 for float32 is a switch of the backends (``tf32``), not a rounding.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at a per-tensor scale, back in t's dtype."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


@contextlib.contextmanager
def tf32(enabled: bool):
    """Matmuls and cuDNN convs in TF32 (enabled) or in full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
