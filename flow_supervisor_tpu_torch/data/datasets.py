"""Dataset catalogs: path lists for each benchmark (a copy of
flow_supervisor_tpu/data/datasets.py over the port's own ``paths``).

Structure parity with the reference (``data/*.py`` and ``pytorch/wb_data/*.py``):

- FlyingChairs: %05d_img{1,2}.ppm pairs, train/val from FlyingChairs_train_val.txt
  (code 1 = train, 2 = val) (data/flyingchairs.py:13-35).
- FlyingThings3D: left cam, into_future + into_past (reversed pairs), clean/final
  passes, PFM flow (data/flyingthings.py:11-69).
- Sintel: scene-wise pairs, clean/final, training/test; Unsup / UnsupInterval
  (i -> i+2) / UnsupPart (fixed 10-scene split) / MultiFrame (data/sintel.py).
- KITTI-2015 / 2012 sparse flow_occ; Multiview sequences (image_2 + image_3,
  frames canonicalized to 375x1242 by center crop-or-pad, sequence-boundary
  filtering) and the +-2-frame Interval variant (data/kitti.py).
- Spring frames (+ Unsup / UnsupInterval) and HD1K sparse flow
  (pytorch/wb_data/{spring,hd1k}.py).
- ``frames_directory``: consecutive frames of an arbitrary directory (DAVIS).

Each catalog returns a list of ``FlowRecord``; ``backward(records)`` reverses the
frame order of every pair (reference ``UnsupDataset.backward``).
"""
from __future__ import annotations

import dataclasses
import os
from glob import glob
from typing import Optional

from flow_supervisor_tpu_torch.data import paths


@dataclasses.dataclass(frozen=True)
class FlowRecord:
    images: tuple[str, ...]
    flow: Optional[str] = None
    sparse: bool = False
    extra: tuple = ()
    canonical_size: Optional[tuple[int, int]] = None  # center crop-or-pad target


def backward(records: list[FlowRecord]) -> list[FlowRecord]:
    return [
        dataclasses.replace(r, images=tuple(reversed(r.images)), flow=None)
        for r in records
    ]


def flying_chairs(training: bool = True) -> list[FlowRecord]:
    code = 1 if training else 2
    out = []
    with open(paths.FLYING_CHAIRS_SPLIT) as f:
        for s, line in enumerate(f):
            if int(line) == code:
                imgs = tuple(
                    os.path.join(paths.FLYING_CHAIRS, "%05d_img%d.ppm" % (s + 1, i))
                    for i in (1, 2)
                )
                flow = os.path.join(paths.FLYING_CHAIRS, "%05d_flow.flo" % (s + 1))
                out.append(FlowRecord(imgs, flow))
    return out


def flying_things(dstype: str = "frames_cleanpass") -> list[FlowRecord]:
    root = paths.FLYING_THINGS
    out = []
    for cam in ["left"]:
        for direction in ["into_future", "into_past"]:
            image_dirs = sorted(glob(os.path.join(root, dstype, "TRAIN/*/*")))
            image_dirs = sorted(os.path.join(f, cam) for f in image_dirs)
            flow_dirs = sorted(glob(os.path.join(root, "optical_flow/TRAIN/*/*")))
            flow_dirs = sorted(os.path.join(f, direction, cam) for f in flow_dirs)
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob(os.path.join(idir, "*.png")))
                flows = sorted(glob(os.path.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        out.append(FlowRecord((images[i], images[i + 1]), flows[i]))
                    else:
                        out.append(FlowRecord((images[i + 1], images[i]), flows[i + 1]))
    return out


def _sintel_scenes(training: bool, dstype: str):
    split = "training" if training else "test"
    image_root = os.path.join(paths.SINTEL, split, dstype)
    flow_root = os.path.join(paths.SINTEL, split, "flow")
    for scene in sorted(os.listdir(image_root)):
        images = sorted(glob(os.path.join(image_root, scene, "*.png")))
        flows = sorted(glob(os.path.join(flow_root, scene, "*.flo")))
        yield scene, images, flows if split == "training" else []


def sintel(training: bool = True, dstype: str = "final") -> list[FlowRecord]:
    out = []
    for scene, images, flows in _sintel_scenes(training, dstype):
        for i in range(len(images) - 1):
            flow = flows[i] if flows else None
            out.append(
                FlowRecord((images[i], images[i + 1]), flow, extra=(scene, i))
            )
    return out


def sintel_unsup_interval(training: bool = True, dstype: str = "final"):
    out = []
    for scene, images, _ in _sintel_scenes(training, dstype):
        for i in range(len(images) - 2):
            out.append(FlowRecord((images[i], images[i + 2]), extra=(scene, i)))
    return out


SINTEL_PART1 = [
    "alley_1", "ambush_2", "bamboo_1", "bandage_1", "cave_2",
    "market_2", "mountain_1", "shaman_2", "sleeping_2", "temple_2",
]


def sintel_unsup_part(part: int = 1, dstype: str = "final") -> list[FlowRecord]:
    assert part in (1, 2)
    out = []
    for scene, images, _ in _sintel_scenes(True, dstype):
        keep = (scene in SINTEL_PART1) if part == 1 else (scene not in SINTEL_PART1)
        if keep:
            for i in range(len(images) - 1):
                out.append(FlowRecord((images[i], images[i + 1]), extra=(scene, i)))
    return out


def sintel_multiframe(training: bool = True, dstype: str = "final"):
    """Frame triplets; labeled triplets carry both flows (i->i+1 as ``flow``,
    i+1->i+2 as ``extra[2]`` — reference SintelMultiFrame keeps a 2-element
    flow path list, data/sintel.py:60-65)."""
    out = []
    for scene, images, flows in _sintel_scenes(training, dstype):
        for i in range(len(images) - 2):
            flow = flows[i] if flows else None
            flow2 = flows[i + 1] if flows else None
            out.append(
                FlowRecord(
                    (images[i], images[i + 1], images[i + 2]),
                    flow,
                    extra=(scene, i, flow2),
                )
            )
    return out


def kitti(training: bool = True) -> list[FlowRecord]:
    split = "training" if training else "testing"
    root = os.path.join(paths.KITTI, "data_scene_flow", split)
    images1 = sorted(glob(os.path.join(root, "image_2/*_10.png")))
    images2 = sorted(glob(os.path.join(root, "image_2/*_11.png")))
    flows = sorted(glob(os.path.join(root, "flow_occ/*_10.png")))
    out = []
    for i, (a, b) in enumerate(zip(images1, images2)):
        flow = flows[i] if split == "training" else None
        out.append(
            FlowRecord((a, b), flow, sparse=True, extra=(os.path.basename(a),))
        )
    return out


def kitti_2012(training: bool = True) -> list[FlowRecord]:
    split = "training" if training else "testing"
    root = os.path.join(paths.KITTI, "data_stereo_flow", split)
    images1 = sorted(glob(os.path.join(root, "colored_0/*_10.png")))
    images2 = sorted(glob(os.path.join(root, "colored_0/*_11.png")))
    flows = sorted(glob(os.path.join(root, "flow_occ/*_10.png")))
    out = []
    for i, (a, b) in enumerate(zip(images1, images2)):
        flow = flows[i] if split == "training" else None
        out.append(
            FlowRecord((a, b), flow, sparse=True, extra=(os.path.basename(a),))
        )
    return out


KITTI_MV_SIZE = (375, 1242)


def kitti_multiview(training: bool = False, interval: int = 1) -> list[FlowRecord]:
    """Multiview sequences from image_2 + image_3: all (i, i+interval) frame
    pairs that stay inside one (camera, sequence) run.

    Intent parity, not construction parity, with the reference
    (data/kitti.py:109-194): the reference enumerates ``images[1:]`` /
    ``images[2:]`` but appends ``images[i-1], images[i]``, which pairs the
    LAST image of the dataset with the first, emits one cross-sequence pair
    after every boundary, and drops each sequence's true last pair. We emit
    the catalog that loop clearly intends — consecutive same-run pairs only —
    keying runs by (camera dir, sequence id) so image_2/image_3 never mix.
    """
    split = "training" if training else "testing"
    root = os.path.join(paths.KITTI, "data_scene_flow_multiview", split)
    images = sorted(
        glob(os.path.join(root, "image_2/*.png"))
        + glob(os.path.join(root, "image_3/*.png"))
    )

    def run_id(p):
        return (
            os.path.basename(os.path.dirname(p)),
            os.path.basename(p).split("_")[0],
        )

    out = []
    for i in range(len(images) - interval):
        a, b = images[i], images[i + interval]
        if run_id(a) != run_id(b):
            continue
        out.append(
            FlowRecord(
                (a, b),
                sparse=True,
                extra=(os.path.basename(a),),
                canonical_size=KITTI_MV_SIZE,
            )
        )
    return out


def spring(interval: int = 1) -> list[FlowRecord]:
    images = sorted(glob(os.path.join(paths.SPRING, "frames", "*.png")))
    return [
        FlowRecord((images[i], images[i + interval]))
        for i in range(len(images) - interval)
    ]


def hd1k() -> list[FlowRecord]:
    out = []
    seq = 0
    while True:
        flows = sorted(
            glob(os.path.join(paths.HD1K, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq))
        )
        images = sorted(
            glob(os.path.join(paths.HD1K, "hd1k_input", "image_2/%06d_*.png" % seq))
        )
        if not flows:
            break
        for i in range(len(flows) - 1):
            out.append(FlowRecord((images[i], images[i + 1]), flows[i], sparse=True))
        seq += 1
    return out


def frames_directory(directory: str, exts=("jpg", "png", "jpeg")) -> list[FlowRecord]:
    images = []
    for e in exts:
        images.extend(glob(os.path.join(directory, f"*.{e}")))
    images = sorted(images)
    return [
        FlowRecord((images[i], images[i + 1]), extra=(os.path.basename(images[i]),))
        for i in range(len(images) - 1)
    ]
