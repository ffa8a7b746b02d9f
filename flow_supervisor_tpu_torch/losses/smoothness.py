"""Edge-aware smoothness losses (counterpart of
flow_supervisor_tpu/losses/smoothness.py): first / second-order flow
gradients under the exponential image-gradient edge weight
exp(-mean|150 g|) of the recipes, with robust_l1 on the flow gradients,
averaged over the x and y terms.

Data parallelism needs nothing here: each loss is a mean over all its
elements, and with equal shards the average of the ranks' means (the
gradients' all-reduce) is the global batch's mean.
"""
from __future__ import annotations

import torch

from flow_supervisor_tpu_torch.losses.photometric import robust_l1

EDGE_CONSTANT = 150.0


def image_grads(image: torch.Tensor, stride: int = 1):
    gh = image[:, stride:] - image[:, :-stride]
    gw = image[:, :, stride:] - image[:, :, :-stride]
    return gh, gw


def edge_weight(image_grad: torch.Tensor) -> torch.Tensor:
    return torch.exp(-torch.mean(torch.abs(EDGE_CONSTANT * image_grad), dim=-1, keepdim=True))


def first_order_smoothness_loss(image, flow) -> torch.Tensor:
    img_gh, img_gw = image_grads(image)
    flow_gh, flow_gw = image_grads(flow)
    return (torch.mean(edge_weight(img_gh) * robust_l1(flow_gh))
            + torch.mean(edge_weight(img_gw) * robust_l1(flow_gw))) / 2.0


def second_order_smoothness_loss(image, flow) -> torch.Tensor:
    img_gh, img_gw = image_grads(image, stride=2)
    flow_gh, flow_gw = image_grads(flow)
    flow_ghh, _ = image_grads(flow_gh)
    _, flow_gww = image_grads(flow_gw)
    return (torch.mean(edge_weight(img_gh) * robust_l1(flow_ghh))
            + torch.mean(edge_weight(img_gw) * robust_l1(flow_gww))) / 2.0
