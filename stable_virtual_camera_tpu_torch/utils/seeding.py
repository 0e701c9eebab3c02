"""Deterministic seeding of the host-side random number generators.

Counterpart of `seed_everything` in stable_virtual_camera_tpu/utils/
seeding.py: the device randomness of the port is drawn from explicitly
seeded `torch.Generator`s, so only Python's and numpy's global generators
(data sampling, augmentation) need seeding here.
"""

from __future__ import annotations

import random

import numpy as np


def seed_everything(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)
