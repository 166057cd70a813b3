"""Uniform per-module console loggers under the port's namespace
(counterpart of ``contrast_gan_3d_tpu/utils/logging_utils.py``).

``create_logger`` gives a logger one console handler on stdout (the JAX
package's default); ``project_logs_to_stderr`` moves every such handler,
and those made later, to stderr, for the commands whose stdout is a
machine-read stream of JSON lines (``b96_probe``, ``bench_host_augment``).
The stream is looked up when a handler is made, so a replaced
``sys.stdout`` (a test's capture) is the one that is written.
"""

import logging
import sys

_FORMAT = "%(asctime)s | %(name)s | %(levelname)s | %(message)s"
_PROJECT_PREFIX = "contrast_gan_3d_tpu_torch"

# the ``sys`` attribute create_logger points new handlers at;
# project_logs_to_stderr() flips it
_DEFAULT_STREAM = "stdout"


def _project_loggers():
    for name, logger in list(logging.root.manager.loggerDict.items()):
        if name.startswith(_PROJECT_PREFIX) and isinstance(logger, logging.Logger):
            yield logger


def create_logger(name: str = _PROJECT_PREFIX, level: int = logging.INFO) -> logging.Logger:
    """``name``'s logger at ``level``, with one console handler (the first
    call adds it) and no propagation to the root logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(getattr(sys, _DEFAULT_STREAM))
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level)
    return logger


def project_logs_to_stderr() -> None:
    """Route every project logger, those that exist and those made later,
    to stderr: a log line on stdout would corrupt a JSON stream. Only
    console handlers aimed at stdout move; a ``FileHandler`` (a
    ``StreamHandler`` too) keeps its file."""
    global _DEFAULT_STREAM
    _DEFAULT_STREAM = "stderr"
    for logger in _project_loggers():
        for h in logger.handlers:
            if isinstance(h, logging.StreamHandler) and getattr(h, "stream", None) in (sys.stdout, sys.__stdout__):
                h.setStream(sys.stderr)


def set_project_loggers_level(level: int) -> None:
    """Set the level of every logger made under the project namespace."""
    for logger in _project_loggers():
        logger.setLevel(level)
