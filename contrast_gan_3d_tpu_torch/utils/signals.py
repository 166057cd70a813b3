"""First-signal-graceful, second-signal-escalate OS signal wiring (the
port's own copy of ``contrast_gan_3d_tpu/utils/signals.py``)."""

import signal
import threading
from typing import Callable, Dict, Optional, Tuple

__all__ = ["install_graceful_stop"]


def install_graceful_stop(
    on_stop: Callable[[str], None],
    is_stopped: Callable[[], bool],
    signums: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
) -> Optional[Dict[int, object]]:
    """Route ``signums`` to a graceful stop, escalating on re-delivery.

    The first delivery calls ``on_stop(signal_name)``; a second delivery
    while ``is_stopped()`` is already true restores the previous handler
    for that signal and raises ``KeyboardInterrupt``. Off the main thread
    (where ``signal.signal`` is not allowed) nothing is installed and None
    is returned; otherwise ``{signum: previous_handler}``."""
    if threading.current_thread() is not threading.main_thread():
        return None
    previous: Dict[int, object] = {}

    def _handler(signum, frame):
        name = signal.Signals(signum).name
        if is_stopped():  # second signal: escalate
            signal.signal(signum, previous[signum])
            raise KeyboardInterrupt(f"{name} received twice — aborting without waiting for the graceful stop")
        on_stop(name)

    for signum in signums:
        previous[signum] = signal.signal(signum, _handler)
    return previous
