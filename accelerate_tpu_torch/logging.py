"""Logging that knows the process.

Counterpart of ``accelerate_tpu/logging.py``: ``get_logger(name,
log_level)`` returns a :class:`MultiProcessAdapter`, which logs on the
main process only unless a call passes ``main_process_only=False``;
``in_order=True`` on the other processes logs one process after another.
The level comes from ``log_level`` or ``ACCELERATE_TPU_LOG_LEVEL``.

It reads the process's place through ``state.current_topology``: the
``PartialState``'s when one exists, else ``torch.distributed`` and the
environment, so a logger works (and never raises for want of CUDA)
before any state exists.
"""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        from .state import current_topology

        return not main_process_only or current_topology()[0] == 0

    def log(self, level, msg, *args, **kwargs):
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)
        if not self.isEnabledFor(level):
            return
        if self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)
        elif in_order:
            from .state import PartialState, current_topology

            index, _, count = current_topology()
            for i in range(count):
                if i == index:
                    msg, kwargs = self.process(msg, kwargs)
                    self.logger.log(level, msg, *args, **kwargs)
                if count > 1:
                    PartialState().wait_for_everyone()

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """``warning``, once for each distinct set of arguments."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """The logger ``name`` behind a :class:`MultiProcessAdapter`, its (and
    the root logger's) level set from ``log_level`` or
    ``ACCELERATE_TPU_LOG_LEVEL`` when either is given."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_TPU_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
