"""Timing of the update block's conv epilogues (kernels/update_epilogue.py)
on the GPU, per update-block iteration of RAFT.

    python -m flow_supervisor_tpu_torch.probe_epilogue [--reps 20]

At the inference cells' grid (B=32, 56x128, bf16) and the evaluation
cell's (B=1, 55x128, fp32), from seeded raw conv outputs of one RAFT
update-block iteration (the 15 convs' outputs, without their bias), it
times, in turns (chain, kernel, kernel, chain; plain between):

- kernel: what the block's fused path runs besides its convs: 13 epilogue
  launches and the copy of the flow's 2 channels into the GRU's input
  (host us per call over these 14);
- plain: the same through the epilogues' plain PyTorch versions on the card;
- chain: what the op chain of the block runs besides its convs (the
  library yardstick): ATen's bias add after each conv, the relus, sigmoids
  and tanhs, the GRU's gating and the seven concatenations.

Times are device ms per 12 iterations (calls queued behind a spin kernel)
beside the epilogues' bound (each byte they read and write once, at 3.35
TB/s), and host us per call of the kernel's wrappers and of the chain's
ops (back to back, no spin). Prints one JSON line per grid. A CUDA device is
required.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from flow_supervisor_tpu_torch.kernels import _build, update_epilogue as epi

GRIDS = {"infer_b32": ((32, 56, 128), torch.bfloat16), "eval_b1": ((1, 55, 128), torch.float32)}
ITERS = 12
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES_PER_S = 2.0e9
# the ACT convs: name -> (channels, relu, scale)
ACT = {"convc1": (256, True, 1.0), "convc2": (192, True, 1.0), "convf1": (128, True, 1.0),
       "convf2": (64, True, 1.0), "conv": (126, True, 1.0), "head1": (256, True, 1.0),
       "head2": (2, False, 1.0), "mask1": (256, True, 1.0), "mask2": (576, False, 0.25)}
GRU = ("z1", "r1", "q1", "z2", "r2", "q2")


def time_ms(fn, reps: int) -> float:
    """Device ms of fn(), the calls queued behind a spin kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host us of one fn() call, back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def iteration(shape, dtype, dev, gen):
    """({kernel, plain, chain, act, gru}: the iteration's callables, (ACT,
    GRU, all) bytes, kernel calls, chain ops) of one iteration."""
    b, h, w = shape

    def rand(c, scale=1.0):
        return (scale * torch.randn(b, h, w, c, generator=gen)).to(dev, dtype)

    raw = {k: rand(c) for k, (c, _, _) in ACT.items()} | {k: rand(128) for k in GRU}
    bias = {k: (0.1 * torch.randn(raw[k].shape[3], generator=gen)).to(dev, dtype) for k in raw}
    net, inp, flow = torch.tanh(rand(128)), torch.relu(rand(128)), rand(2, 2.0)
    hx, cf, state = rand(384), rand(256), rand(128)

    def fused(f_act, f_gate, f_update):
        def act(k, out=None):
            c, relu, scale = ACT[k]
            return f_act(raw[k], bias[k], raw[k] if out is None else out, relu, scale)

        act("convc1")
        act("convc2", cf[..., :192])
        act("convf1")
        act("convf2", cf[..., 192:])
        act("conv", hx[..., 256:382])
        hx[..., 382:].copy_(flow)
        hh = net
        for p in ("1", "2"):
            f_gate(raw["z" + p], raw["r" + p], bias["z" + p], bias["r" + p], hh, hx[..., :128])
            f_update(raw["q" + p], bias["q" + p], raw["z" + p], hh, state, hx[..., :128])
            hh = state
        for k in ("head1", "head2", "mask1", "mask2"):
            act(k)

    def kernel():
        fused(epi.bias_act, epi.gru_gate, epi.gru_update)

    def noop(*args):
        pass

    def kernel_act():  # the ACT launches (and the flow's copy) alone
        fused(epi.bias_act, noop, noop)

    def kernel_gru():  # the GRU's gate and update launches alone
        fused(noop, epi.gru_gate, epi.gru_update)

    def plain():
        fused(epi.bias_act_plain, epi.gru_gate_plain, epi.gru_update_plain)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def chain():
        def conv(k):  # ATen's bias add after a cuDNN conv, in place
            return nchw(raw[k]).add_(bias[k].reshape(1, -1, 1, 1))

        relu = torch.relu
        cor = relu(conv("convc2"))
        relu(conv("convc1"))
        flo = relu(conv("convf2"))
        relu(conv("convf1"))
        out = relu(conv("conv"))
        torch.cat([cor, flo], dim=1)
        x = torch.cat([nchw(inp), torch.cat([out, nchw(flow)], dim=1)], dim=1)
        hh = nchw(net)
        for p in ("1", "2"):
            torch.cat([hh, x], dim=1)
            z = torch.sigmoid(conv("z" + p))
            r = torch.sigmoid(conv("r" + p))
            torch.cat([r * hh, x], dim=1)
            q = torch.tanh(conv("q" + p))
            hh = (1.0 - z) * hh + z * q
        relu(conv("head1"))
        conv("head2")
        torch.relu_(conv("mask1"))
        0.25 * conv("mask2")

    e = torch.finfo(dtype).bits // 8
    px = b * h * w
    act_bytes = 2 * sum(c for c, _, _ in ACT.values()) * px * e
    gru_bytes = 2 * 2 * (5 * 128) * px * e  # each pass: gate 3 in, 2 out; update 3 in, 2 out
    nbytes = act_bytes + gru_bytes + 2 * 2 * px * e  # and the flow's copy
    # 15 bias adds, 7 relus, 7 concatenations, 8 ops a GRU pass, the mask's scale
    chain_ops = 15 + 7 + 7 + 2 * 8 + 1
    return {"kernel": kernel, "plain": plain, "chain": chain, "act": kernel_act,
            "gru": kernel_gru}, (act_bytes, gru_bytes, nbytes), len(ACT) + 4 + 1, chain_ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_epilogue needs a CUDA device")
    dev = torch.device("cuda")
    _build.lib()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name, (shape, dtype) in GRIDS.items():
        gen = torch.Generator().manual_seed(22)
        fns, (act_bytes, gru_bytes, nbytes), calls, ops = iteration(shape, dtype, dev, gen)
        c1 = time_ms(fns["chain"], args.reps)
        k1 = time_ms(fns["kernel"], args.reps)
        p = time_ms(fns["plain"], args.reps)
        k2 = time_ms(fns["kernel"], args.reps)
        c2 = time_ms(fns["chain"], args.reps)
        act, gru = time_ms(fns["act"], args.reps), time_ms(fns["gru"], args.reps)

        def bound(n):
            return ITERS * n / HBM_BYTES_PER_S * 1e3

        print(json.dumps({
            "grid": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "gpu": gpu, "iterations": ITERS,
            "kernel_ms": ITERS * (k1 + k2) / 2, "plain_ms": ITERS * p,
            "chain_ms": ITERS * (c1 + c2) / 2, "bound_ms": bound(nbytes),
            "act_ms": ITERS * act, "act_bound_ms": bound(act_bytes),
            "gru_ms": ITERS * gru, "gru_bound_ms": bound(gru_bytes),
            "bytes_per_iteration": nbytes,
            "kernel_host_us_per_call": host_us(fns["kernel"], args.reps) / calls,
            "chain_host_us_per_op": host_us(fns["chain"], args.reps) / ops,
        }), flush=True)


if __name__ == "__main__":
    main()
