"""The update block's conv epilogues (csrc/update_epilogue.cu): a bias-free
conv output's bias, activation and GRU gating in one pass, written at a
channel offset of the buffer the next conv reads.

- ``bias_act``: out = act(x + bias) * scale, act relu or none, scale 1 or
  0.25 (the convex-upsampling mask's; exact in any dtype);
- ``gru_gate``: z <- sigmoid(z + bz), kept for ``gru_update``, and
  rh = sigmoid(r + br) * h, written into the h slot of the GRU's [h | x];
- ``gru_update``: h' = (1 - z) * h + z * tanh(q + bq) into the hidden state
  and into that slot again, for the next pass.

Every tensor is [B, H, W, C] with channels innermost and the pixels at one
row stride (``row_stride``): a channel slice of a contiguous NHWC buffer, so
outputs land inside the wider buffers of models/update.py. Biases are
the convs' [C] parameters as they are, fp32 or the tensors' dtype (fp32
or bf16: a model held in bf16, or in fp32 and run in bf16), so no caller
casts them; the arithmetic is fp32, rounded once to the tensors' dtype.
``out`` may be ``x`` itself (ACT), the state ``h`` (UPDATE); ``gru_gate``
writes sigmoid(z) over z.

The kernel replaces no TPU kernel (XLA fuses these ops into its convs): on
the H100 ATen's bias adds, activations and concatenations were 34 % of an
inference pair's device time (PERF.md §5). Each wrapper takes its plain
PyTorch version only for CPU tensors; for CUDA tensors it launches the
kernel or raises. ``launches`` counts kernel launches; ``fused_passes``
counts update-block calls that took the fused path (the no-grad path of
models/update.py and models/gma.py), on the CPU too.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.kernels import _build

MAX_CHANNELS = 2048  # 8 channels a thread, 256 threads: one pixel row a pass
ACT, GATE, UPDATE = 0, 1, 2

_DTYPE_CODES = {torch.float32: _build.DTYPE_CODES["float32"],
                torch.bfloat16: _build.DTYPE_CODES["bfloat16"]}

launches = 0
fused_passes = 0


def row_stride(t: torch.Tensor, what: str) -> int:
    """The pixel row stride of t [B, H, W, C] whose channels are innermost and
    whose pixels are evenly spaced (a channel slice of a contiguous NHWC
    buffer); raises for any other layout."""
    shape, stride = t.shape, t.stride()
    if len(shape) == 4 and 0 < shape[3] <= MAX_CHANNELS:
        b, h, w, c = shape
        sb, sh, sw, sc = stride
        s = sw if w > 1 else sh if h > 1 else sb if b > 1 else c
        if (b * h * w and s >= c and (sc == 1 or c == 1) and (sh == w * s or h == 1)
                and (sb == h * w * s or b == 1)):
            return s
    raise ValueError(f"{what}: needs a non-empty [B, H, W, C] tensor, C <= {MAX_CHANNELS}, "
                     f"channels innermost and pixels evenly spaced, got shape {tuple(shape)} "
                     f"strides {stride}")


def _strides(what: str, tensors: tuple, biases: tuple) -> list:
    """Checks that ``tensors`` (None where a mode has none) share the first
    one's shape and dtype (fp32 or bf16) and have ``row_stride``'s layout,
    and that ``biases`` are contiguous [C], all fp32 or all of that dtype ->
    the tensors' row strides (0 for None)."""
    x = tensors[0]
    shape, dtype = x.shape, x.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: takes float32 or bfloat16, got {dtype}")
    strides = []
    for t in tensors:
        if t is None:
            strides.append(0)
            continue
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{what}: a {t.dtype} {tuple(t.shape)} tensor beside "
                             f"{dtype} {tuple(shape)}")
        strides.append(row_stride(t, what))
    bias_dtype = biases[0].dtype
    for b in biases:
        if b is not None and (b.shape != shape[3:] or b.dtype not in (torch.float32, dtype)
                              or b.dtype != bias_dtype or b.stride() != (1,)):
            raise ValueError(f"{what}: a bias must be a contiguous [{shape[3]}] of "
                             f"torch.float32 or {dtype}, the same for both, got {b.dtype} "
                             f"{tuple(b.shape)}")
    return strides


def _launch(what: str, mode: int, tensors: tuple, biases: tuple, strides: list,
            relu: bool = False, scale: float = 1.0) -> None:
    """One launch on tensors (a, b, h, o0, o1) and biases (bias0, bias1) of
    csrc/update_epilogue.cu's mode, None where the mode has none, on the
    tensors' device and its current stream. The block makes 13 a RAFT
    iteration, so this path asks the runtime for little: the raw stream
    handle, and the device switch only where the tensors are not on the
    current device."""
    global launches
    x = tensors[0]
    ptrs = [0 if t is None else t.data_ptr() for t in (*tensors, *biases)]
    args = [v for pair in zip(ptrs[:5], strides) for v in pair]
    bsz, h, w, c = x.shape
    dev = x.device.index

    def call():
        return _build.lib().fst_update_epilogue(
            mode, _DTYPE_CODES[x.dtype], _DTYPE_CODES[biases[0].dtype], bsz * h * w, c,
            *args[:6], *ptrs[5:], *args[6:],
            int(relu), float(scale), torch._C._cuda_getCurrentRawStream(dev),
        )

    if dev == torch.cuda.current_device():
        rc = call()
    else:
        with torch.cuda.device(dev):
            rc = call()
    _build.check(rc, what)
    launches += 1


def bias_act_plain(x, bias, out, relu: bool = False, scale: float = 1.0) -> torch.Tensor:
    y = x.float() + bias.float()
    if relu:
        y = torch.clamp(y, min=0.0)
    if scale != 1.0:
        y = y * scale
    return out.copy_(y)


def bias_act(x: torch.Tensor, bias: torch.Tensor, out: torch.Tensor | None = None,
             relu: bool = False, scale: float = 1.0) -> torch.Tensor:
    """out = act(x + bias) * scale for a raw conv output x [B, H, W, C]
    (``out`` default x itself, in place) -> out."""
    out = x if out is None else out
    tensors, biases = (x, None, None, out, None), (bias, None)
    strides = _strides("bias_act", tensors, biases)
    if not _build.uses_kernel("bias_act", x, bias, out):
        return bias_act_plain(x, bias, out, relu, scale)
    _launch("bias_act", ACT, tensors, biases, strides, relu, scale)
    return out


def gru_gate_plain(z, r, bias_z, bias_r, h, rh) -> torch.Tensor:
    zs = torch.sigmoid(z.float() + bias_z.float())
    rh.copy_(torch.sigmoid(r.float() + bias_r.float()) * h.float())
    return z.copy_(zs)


def gru_gate(z: torch.Tensor, r: torch.Tensor, bias_z: torch.Tensor, bias_r: torch.Tensor,
             h: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """The GRU's gates from the raw convz / convr outputs: sigmoid(z + bias_z)
    over z, sigmoid(r + bias_r) * h into ``rh`` -> z."""
    tensors, biases = (z, r, h, z, rh), (bias_z, bias_r)
    strides = _strides("gru_gate", tensors, biases)
    if not _build.uses_kernel("gru_gate", z, r, bias_z, bias_r, h, rh):
        return gru_gate_plain(z, r, bias_z, bias_r, h, rh)
    _launch("gru_gate", GATE, tensors, biases, strides)
    return z


def gru_update_plain(q, bias_q, z, h, out, slot) -> torch.Tensor:
    zf = z.float()
    hn = (1.0 - zf) * h.float() + zf * torch.tanh(q.float() + bias_q.float())
    slot.copy_(hn)
    return out.copy_(hn)


def gru_update(q: torch.Tensor, bias_q: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
               out: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """h' = (1 - z) * h + z * tanh(q + bias_q) from the raw convq output q and
    ``gru_gate``'s z, into ``out`` (may be h) and ``slot`` -> out."""
    tensors, biases = (q, z, h, out, slot), (bias_q, None)
    strides = _strides("gru_update", tensors, biases)
    if not _build.uses_kernel("gru_update", q, bias_q, z, h, out, slot):
        return gru_update_plain(q, bias_q, z, h, out, slot)
    _launch("gru_update", UPDATE, tensors, biases, strides)
    return out
