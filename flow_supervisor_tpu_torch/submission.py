"""Benchmark submission writers (counterpart of
flow_supervisor_tpu/submission.py): an ``Evaluator``'s model over the Sintel
test split, with optional warm start within a scene, writing Middlebury
``.flo`` files as <out>/<dstype>/<scene>/frame%04d.flo, and over the KITTI
test split, writing 16-bit flow PNGs as <out>/<frame name>."""
from __future__ import annotations

import os

from flow_supervisor_tpu_torch.data import datasets as D
from flow_supervisor_tpu_torch.data.io import read_image, write_flo, write_flow_kitti
from flow_supervisor_tpu_torch.utils.warm_start import forward_interpolate


def create_sintel_submission(
    evaluator, output_path: str = "sintel_submission", warm_start: bool = False
) -> None:
    for dstype in ("clean", "final"):
        prev_scene, prev_low = None, None
        for rec in D.sintel(training=False, dstype=dstype):
            scene, idx = rec.extra
            img1 = read_image(rec.images[0])
            img2 = read_image(rec.images[1])
            flow_init = None
            if warm_start and prev_low is not None and scene == prev_scene:
                flow_init = forward_interpolate(prev_low)
            prev_scene = scene
            results, prev_low = evaluator.predict(img1, img2, "sintel", flow_init)
            out_dir = os.path.join(output_path, dstype, scene)
            os.makedirs(out_dir, exist_ok=True)
            write_flo(os.path.join(out_dir, "frame%04d.flo" % (idx + 1)), results["student"][0])


def create_kitti_submission(evaluator, output_path: str = "kitti_submission") -> None:
    os.makedirs(output_path, exist_ok=True)
    for rec in D.kitti(training=False):
        (frame_id,) = rec.extra
        img1 = read_image(rec.images[0])
        img2 = read_image(rec.images[1])
        results, _ = evaluator.predict(img1, img2, "kitti")
        write_flow_kitti(os.path.join(output_path, frame_id), results["student"][0])
