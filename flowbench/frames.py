"""Seeded inputs, made on the device in a few large calls.

Frames are textured (value noise at three scales, per channel) and a pair's
second frame is the first sampled at x + d(x), d a smooth random field of
``motion_px`` pixels' standard deviation, so d is the pair's true flow. A
scene is a sequence of frames, each the first texture moved by t * d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MARGIN = 64  # px of texture around the frame, so displaced samples stay on texture


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def texture(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, 3, h + 2 MARGIN, w + 2 MARGIN] in [0, 1]."""
    H, W = h + 2 * MARGIN, w + 2 * MARGIN
    img = torch.zeros((n, 3, H, W), device=device)
    for cell, amp in ((64, 0.45), (16, 0.35), (4, 0.2)):
        low = torch.rand((n, 3, H // cell + 2, W // cell + 2), generator=gen, device=device)
        img += amp * F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    return img.clamp(0.0, 1.0)


def smooth_field(gen: torch.Generator, n: int, h: int, w: int, motion_px: float,
                 device) -> torch.Tensor:
    """[n, h, w, 2] smooth displacement (x, y) in px."""
    low = torch.randn((n, 2, 4, 8), generator=gen, device=device)
    field = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    return (motion_px * field).permute(0, 2, 3, 1).contiguous()


def sample(tex: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """The texture's frame window sampled at x + disp -> [n, h, w, 3]."""
    n, _, H, W = tex.shape
    h, w = disp.shape[1], disp.shape[2]
    y, x = torch.meshgrid(torch.arange(h, device=tex.device), torch.arange(w, device=tex.device),
                          indexing="ij")
    px = x.float() + MARGIN + disp[..., 0]
    py = y.float() + MARGIN + disp[..., 1]
    g = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0], -1)
    out = F.grid_sample(tex, g, mode="bilinear", padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1).contiguous()


def pairs(gen, n: int, h: int, w: int, motion_px: float, device):
    """(img1, img2, flow): n textured pairs [n, h, w, 3] and their flow."""
    tex = texture(gen, n, h, w, device)
    flow = smooth_field(gen, n, h, w, motion_px, device)
    return sample(tex, torch.zeros_like(flow)), sample(tex, flow), flow


def scene(gen, frames: int, h: int, w: int, motion_px: float, device) -> torch.Tensor:
    """[frames, h, w, 3]: one texture moved by t * d at frame t."""
    tex = texture(gen, 1, h, w, device)
    flow = smooth_field(gen, 1, h, w, motion_px, device)
    return torch.cat([sample(tex, t * flow) for t in range(frames)])


def valid_mask(gen, n: int, h: int, w: int, share_invalid: float, device) -> torch.Tensor:
    """[n, h, w, 1] float: 1 but at about ``share_invalid`` of the pixels."""
    return (torch.rand((n, h, w, 1), generator=gen, device=device) >= share_invalid).float()
