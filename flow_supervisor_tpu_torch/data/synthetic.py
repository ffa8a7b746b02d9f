"""A synthetic dataset tree with every catalog's layout (counterpart of
flow_supervisor_tpu/data/synthetic.py), written by the port's own writers:
no cv2.

    from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree
    build_synthetic_tree("/tmp/datasets", sizes={"sintel": (436, 1024)})

Frames are uniform random RGB noise, flows N(0, 1) px. Beside the JAX
package's tree it holds FlyingChairs (``.ppm`` pairs, ``.flo`` flows and the
train / val split file). DAVIS frames are baseline JPEG (``.jpg``), as the
JAX package's tree writes them with cv2, here by the port's own encoder
(``data.io.write_jpeg``, 4:2:0 at quality 90).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from flow_supervisor_tpu_torch.data.io import (
    write_flo, write_flow_kitti, write_jpeg, write_pfm, write_png, write_ppm)

DATASETS = ("sintel", "things", "chairs", "kitti", "hd1k", "davis")


def build_synthetic_tree(root, hw=(48, 64), sizes=None, frames: int = 3,
                         chairs_pairs: int = 3, seed: int = 0) -> None:
    """Populate ``root`` with Sintel (training with flows, test), FlyingThings,
    FlyingChairs, KITTI 2015 (training) and multiview (testing), HD1K and
    DAVIS trees whose layouts match the catalogs (``data/datasets.py``).

    Every dataset's frames are ``hw`` (h, w) unless ``sizes`` names its own
    (keys: ``DATASETS``). Sintel scenes and the FlyingThings sequence have
    ``frames`` frames; FlyingChairs has ``chairs_pairs`` pairs, the last one
    in the validation split and the rest in training."""
    sizes = {name: tuple(hw) for name in DATASETS} | dict(sizes or {})
    unknown = set(sizes) - set(DATASETS)
    if unknown:
        raise ValueError(f"build_synthetic_tree: unknown datasets {sorted(unknown)}")
    root = Path(root)
    rng = np.random.default_rng(seed)

    def image(path, name):
        h, w = sizes[name]
        frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        writer = {".ppm": write_ppm, ".jpg": write_jpeg}.get(Path(path).suffix, write_png)
        writer(str(path), frame)

    def flow(name):
        h, w = sizes[name]
        return rng.normal(0, 1, (h, w, 2)).astype(np.float32)

    def mkdir(path):
        path.mkdir(parents=True, exist_ok=True)
        return path

    # sintel training (one scene, clean + final, flows) and test
    for split, scene in (("training", "alley_1"), ("test", "wall")):
        for dstype in ("clean", "final"):
            d = mkdir(root / "Sintel" / split / dstype / scene)
            for i in range(frames):
                image(d / f"frame_{i + 1:04d}.png", "sintel")
    fd = mkdir(root / "Sintel/training/flow/alley_1")
    for i in range(frames - 1):
        write_flo(str(fd / f"frame_{i + 1:04d}.flo"), flow("sintel"))

    # things: one sequence, both passes, flows both ways
    for pas in ("frames_cleanpass", "frames_finalpass"):
        d = mkdir(root / "FlyingThings" / pas / "TRAIN/A/0000/left")
        for i in range(frames):
            image(d / f"{i:04d}.png", "things")
    h, w = sizes["things"]
    for direction in ("into_future", "into_past"):
        d = mkdir(root / "FlyingThings/optical_flow/TRAIN/A/0000" / direction / "left")
        for i in range(frames):
            write_pfm(str(d / f"{i:04d}.pfm"), rng.normal(0, 1, (h, w, 3)).astype(np.float32))

    # flying chairs: pairs, flows and the split file (1 train, 2 val)
    d = mkdir(root / "FlyingChairs/FlyingChairs_release/data")
    for s in range(1, chairs_pairs + 1):
        image(d / f"{s:05d}_img1.ppm", "chairs")
        image(d / f"{s:05d}_img2.ppm", "chairs")
        write_flo(str(d / f"{s:05d}_flow.flo"), flow("chairs"))
    with open(root / "FlyingChairs/FlyingChairs_train_val.txt", "w") as f:
        f.write("".join("2\n" if s == chairs_pairs else "1\n" for s in range(1, chairs_pairs + 1)))

    # kitti 2015 training + multiview testing
    k = root / "KITTI/data_scene_flow/training"
    mkdir(k / "image_2")
    mkdir(k / "flow_occ")
    for i in range(2):
        image(k / "image_2" / f"{i:06d}_10.png", "kitti")
        image(k / "image_2" / f"{i:06d}_11.png", "kitti")
        write_flow_kitti(str(k / "flow_occ" / f"{i:06d}_10.png"), flow("kitti"))
    mv = mkdir(root / "KITTI/data_scene_flow_multiview/testing/image_2")
    for i in range(3):
        image(mv / f"000000_{i:02d}.png", "kitti")

    # hd1k
    hi = mkdir(root / "HD1K/hd1k_input/image_2")
    hf = mkdir(root / "HD1K/hd1k_flow_gt/flow_occ")
    for i in range(2):
        image(hi / f"000000_{i:04d}.png", "hd1k")
        write_flow_kitti(str(hf / f"000000_{i:04d}.png"), flow("hd1k"))

    # davis
    dv = mkdir(root / "DAVIS/JPEGImages/480p/bear")
    for i in range(3):
        image(dv / f"{i:05d}.jpg", "davis")
