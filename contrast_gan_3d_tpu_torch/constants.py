"""Constants the port shares across modules (its own copy of the values in
``contrast_gan_3d_tpu/constants.py``)."""

# scans are shifted and clipped into this Hounsfield-unit range at load time
MIN_HU, MAX_HU = -1024, 1500

# every volume is reoriented to LPS and stored (W, H, D) = (x, y, z)
ORIENTATION = "LPS"
