"""Plain PyTorch reference of the flow supervisor's train step (Im et al.,
ECCV 2022; the Sintel recipe of the reference train.sh): float32, autograd,
imports nothing of the program under test.

- Supervised branch, forward direction only: the student on the crop (every
  iteration upsampled), then the teacher head from the student's final
  hidden state and low flow zero-padded into the full frame, with the full
  frame's context and pyramid (no gradient into those), each teacher
  iteration upsampled over the full frame and cut to the crop. Loss: the
  student's robust sequence loss against the label (decay ``gamma``) plus
  L_fl, the teacher's against the label (decay ``lfl_decay``).
- Unsupervised branch, both directions, the teacher without gradient and
  only its last flow upsampled: L_fr, the student's sequence loss against
  the teacher's final flow, times B * h * w of the crop (a pixel sum).
- Each branch its own gradient; a parameter's gradient is the sum of both.
- The optimizer: per-tensor clipping to ``clip_norm``, Adam with epsilon on
  the uncorrected sqrt(v), the learning rate times ``lr_decay_rate`` every
  ``lr_decay_steps`` steps, decoupled decay ``weight_decay * lr``; batch
  norm's scale and bias (frozen, eval mode) are not trained.
"""
from __future__ import annotations

import math

import torch

from flowbench.reference.raft import Raft, grid, nchw, nhwc

MAX_FLOW = 400.0


def robust(pred, gt, valid):
    mask = (torch.linalg.vector_norm(gt, dim=-1, keepdim=True) < MAX_FLOW).float()
    if valid is not None:
        mask = mask * valid
    d = pred - gt
    return torch.mean(torch.sqrt(d * d + 1e-6) * mask)


def sequence_loss(preds, gt, valid, gamma):
    n = len(preds)
    return sum(gamma ** (n - 1 - i) * robust(p, gt, valid) for i, p in enumerate(preds))


def pad_into(x, yx8, size):
    """x [B, h, w, C] zero-padded into a [B, *size, C] canvas at yx8 [B, 2]."""
    out = x.new_zeros((x.shape[0], *size, x.shape[3]))
    for b, (y, xx) in enumerate(yx8.tolist()):
        out[b, y : y + x.shape[1], xx : xx + x.shape[2]] = x[b]
    return out


def crop(x, yx, size):
    return torch.stack([x[b, y : y + size[0], xx : xx + size[1]]
                        for b, (y, xx) in enumerate(yx.tolist())])


class SemiStep:
    """The step from float32 ``params`` (a state dict), over ``(sup, unsup)``
    batch dicts on the device. ``cfg``: iters, teacher_iters, gamma,
    lfl_decay, lr, lr_decay_rate, lr_decay_steps, weight_decay, clip_norm."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, cfg: dict, gma: bool = False, heads: int = 1, quant=None):
        bn = {k.rsplit(".", 1)[0] for k in params if k.endswith(".running_mean")}
        self.trained = [k for k in params
                        if k.rsplit(".", 1)[0] not in bn and not k.endswith(("running_mean",
                                                                              "running_var"))]
        self.p = {k: v.detach().clone().requires_grad_(k in self.trained)
                  for k, v in params.items()}
        self.net = Raft(self.p, gma=gma, heads=heads, quant=quant)
        self.cfg = cfg
        self.count = 0
        self.mu = {k: torch.zeros_like(self.p[k]) for k in self.trained}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in self.trained}

    def _direction(self, img, vols, t_vols, orig, yx, teacher_every, teacher_grad):
        r, c = self.net, self.cfg
        b, h, w, _ = img.shape
        net, inp = r.context(img)
        coords0 = grid(b, h // 8, w // 8, img.device)
        net, lows, ups = r.iterate("update_block", net, inp, vols, coords0, coords0,
                                   c["iters"], r.attention(inp), every=True)
        fh8, fw8 = orig.shape[1] // 8, orig.shape[2] // 8
        yx8 = yx // 8
        t_net = nchw(pad_into(nhwc(net.detach()), yx8, (fh8, fw8)))
        t_flow = pad_into(lows[-1].detach(), yx8, (fh8, fw8))
        with torch.no_grad():
            _, t_inp = r.context(orig)
            t_attn = r.attention(t_inp)
        t0 = grid(b, fh8, fw8, img.device)
        with torch.set_grad_enabled(teacher_grad):
            _, _, t_ups = r.iterate("teacher_update_block", t_net, t_inp, t_vols, t0, t0 + t_flow,
                                    c["teacher_iters"], t_attn, every=teacher_every)
        return ups, [crop(u, yx, (h, w)) for u in t_ups]

    def _pyramids(self, batch, both: bool):
        r = self.net
        f1, f2 = r.features(batch["image1"], batch["image2"])
        with torch.no_grad():
            t1, t2 = r.features(batch["orig_image1"], batch["orig_image2"])
            t_fw = r.pyramid(t1, t2)
            t_bw = r.pyramid(t2, t1) if both else None
        return r.pyramid(f1, f2), (r.pyramid(f2, f1) if both else None), t_fw, t_bw

    def sup_loss(self, sup):
        c = self.cfg
        vols, _, t_vols, _ = self._pyramids(sup, both=False)
        stu, tea = self._direction(sup["image1"], vols, t_vols, sup["orig_image1"],
                                   sup["crop_yx"], True, True)
        return (sequence_loss(stu, sup["flow"], sup["valid"], c["gamma"])
                + sequence_loss(tea, sup["flow"], sup["valid"], c["lfl_decay"]))

    def unsup_loss(self, unsup):
        fw, bw, t_fw, t_bw = self._pyramids(unsup, both=True)
        lfr = 0.0
        for img, orig, v, tv in ((unsup["image1"], unsup["orig_image1"], fw, t_fw),
                                 (unsup["image2"], unsup["orig_image2"], bw, t_bw)):
            stu, tea = self._direction(img, v, tv, orig, unsup["crop_yx"], False, False)
            lfr = lfr + sequence_loss(stu, tea[-1].detach(), None, self.cfg["gamma"])
        b, h, w = unsup["image1"].shape[:3]
        return lfr * float(b * h * w)

    def grads(self, sup, unsup):
        """(the merged gradient of each trained tensor, sup_loss, unsup_loss),
        one branch's graph at a time."""
        leaves = [self.p[k] for k in self.trained]
        total = {k: torch.zeros_like(self.p[k]) for k in self.trained}
        losses = []
        for branch, batch in ((self.sup_loss, sup), (self.unsup_loss, unsup)):
            loss = branch(batch)
            for k, g in zip(self.trained, torch.autograd.grad(loss, leaves, allow_unused=True)):
                if g is not None:
                    total[k] += g
            losses.append(float(loss.detach()))
        return total, losses[0], losses[1]

    @torch.no_grad()
    def apply(self, grads: dict) -> dict:
        """One optimizer update -> the clipped gradients it took."""
        c = self.cfg
        lr = c["lr"] * c["lr_decay_rate"] ** math.floor(self.count / c["lr_decay_steps"])
        self.count += 1
        alpha = math.sqrt(1.0 - self.B2 ** self.count) / (1.0 - self.B1 ** self.count)
        clipped = {}
        for k in self.trained:
            g = grads[k]
            g = g * min(1.0, c["clip_norm"] / max(float(torch.linalg.vector_norm(g)), 1e-12))
            clipped[k] = g
            self.mu[k] = self.B1 * self.mu[k] + (1.0 - self.B1) * g
            self.nu[k] = self.B2 * self.nu[k] + (1.0 - self.B2) * g * g
            u = alpha * self.mu[k] / (torch.sqrt(self.nu[k]) + self.EPS)
            self.p[k] -= lr * u + c["weight_decay"] * lr * self.p[k]
        return clipped

    def step(self, sup, unsup) -> dict:
        """One step -> the gradients as computed ("raw") and as clipped, and
        the two losses."""
        grads, sup_loss, unsup_loss = self.grads(sup, unsup)
        return {"raw": grads, "clipped": self.apply(grads), "sup_loss": sup_loss,
                "unsup_loss": unsup_loss}
