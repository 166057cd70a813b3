"""Constants the port shares across modules (its own copy of the values in
``contrast_gan_3d_tpu/constants.py``)."""

from enum import Enum

import numpy as np

# the 19^3 patch around each coronary ostium, resampled at 0.5 mm, whose HU
# labels a scan's contrast
AORTIC_ROOT_PATCH_SIZE = np.array([19] * 3)
AORTIC_ROOT_PATCH_SPACING = np.array([0.5] * 3)

# scans are shifted and clipped into this Hounsfield-unit range at load time
MIN_HU, MAX_HU = -1024, 1500
# the display window of the figures (level 240, window 1000)
VMIN, VMAX = -260, 740

# every volume is reoriented to LPS and stored (W, H, D) = (x, y, z)
ORIENTATION = "LPS"


class ScanType(Enum):
    """A scan's contrast label (the mean HU in the aortic root)."""

    OPT = 0  # 300 < mu < 500 HU
    LOW = -1  # mu <= 300 HU
    HIGH = 1  # mu >= 500 HU
