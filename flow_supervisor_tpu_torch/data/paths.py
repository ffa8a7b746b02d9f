"""Dataset root paths (counterpart of flow_supervisor_tpu/data/paths.py),
under ``datasets`` or the directory the FST_DATA_ROOT environment variable
names, read when the module is imported."""
from __future__ import annotations

import os

DATA_ROOT = os.environ.get("FST_DATA_ROOT", "datasets")

FLYING_CHAIRS = os.path.join(DATA_ROOT, "FlyingChairs/FlyingChairs_release/data")
FLYING_CHAIRS_SPLIT = os.path.join(DATA_ROOT, "FlyingChairs/FlyingChairs_train_val.txt")
FLYING_THINGS = os.path.join(DATA_ROOT, "FlyingThings")
KITTI = os.path.join(DATA_ROOT, "KITTI")
SINTEL = os.path.join(DATA_ROOT, "Sintel")
SPRING = os.path.join(DATA_ROOT, "spring")
HD1K = os.path.join(DATA_ROOT, "HD1K")
DAVIS = os.path.join(DATA_ROOT, "DAVIS")
