"""Project path layout (the port's own copy of the paths it uses from
``contrast_gan_3d_tpu/config.py``).

Everything is rooted at ``CGAN3D_HOME`` (by default the checkout); the logs
directory moves with ``CGAN3D_LOGS_DIR``.
"""

import os
from pathlib import Path

PROJECT_DIR = Path(os.environ.get("CGAN3D_HOME", Path(__file__).resolve().parent.parent))
LOGS_DIR = Path(os.environ.get("CGAN3D_LOGS_DIR", PROJECT_DIR / "logs"))
