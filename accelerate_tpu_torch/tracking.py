"""Experiment trackers.

Counterpart of ``accelerate_tpu/tracking.py``: the ``GeneralTracker``
base, whose methods run on the main process only, the dependency-free
``JSONLTracker`` (``<logging_dir>/<run>/metrics.jsonl``, one JSON object
a call, in the reference's format), and the trackers of tensorboard,
wandb, mlflow, comet_ml, aim, clearml and dvclive, each available when
its package is importable. ``filter_trackers`` resolves an
``Accelerator(log_with=...)``; ``resolve_trackers`` builds them at
``init_trackers``.

The port runs one process, which is the main one unless
``torch.distributed`` says otherwise. TensorBoard counts as available
when ``tensorboard`` or ``tensorboardX`` is importable (the reference
also counts a bare torch, whose ``torch.utils.tensorboard`` then fails to
import). Nothing here imports JAX.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time
from enum import Enum
from functools import wraps
from typing import Optional, Union

logger = logging.getLogger(__name__)


class LoggerType(str, Enum):
    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    MLFLOW = "mlflow"
    COMETML = "comet_ml"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    JSONL = "jsonl"

    def __str__(self):
        return self.value


def _available(*packages) -> bool:
    for name in packages:
        try:
            if importlib.util.find_spec(name) is not None:
                return True
        except (ImportError, ValueError):
            # a module in sys.modules without a spec (a test's stub)
            continue
    return False


def _is_main_process() -> bool:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except ImportError:
        pass
    return True


def on_main_process(function):
    """Run a tracker method on the main process only, unless the tracker
    sets ``main_process_only = False``."""

    @wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if not getattr(self, "main_process_only", True) or _is_main_process():
            return function(self, *args, **kwargs)

    return execute_on_main_process


def get_available_trackers() -> list:
    out = [LoggerType.JSONL]
    for kind, packages in ((LoggerType.TENSORBOARD, ("tensorboard", "tensorboardX")),
                           (LoggerType.WANDB, ("wandb",)), (LoggerType.MLFLOW, ("mlflow",)),
                           (LoggerType.COMETML, ("comet_ml",)), (LoggerType.AIM, ("aim",)),
                           (LoggerType.CLEARML, ("clearml",)),
                           (LoggerType.DVCLIVE, ("dvclive",))):
        if _available(*packages):
            out.append(kind)
    return out


class GeneralTracker:
    """The tracker interface: ``store_init_configuration``, ``log`` and
    ``finish``, with ``tracker`` the backend's own object. A blank one
    (``get_tracker`` of an unknown name) does nothing."""

    main_process_only = True
    name = "blank"
    requires_logging_directory = False

    def __init__(self, _blank: bool = False):
        self._blank = _blank

    @property
    def tracker(self):
        return None

    def store_init_configuration(self, values: dict):
        pass

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        pass

    def finish(self):
        pass


class JSONLTracker(GeneralTracker):
    """Append-only metrics file, one JSON object per call:
    ``{"event": "config", "values"}`` and ``{"event": "log", "step",
    "time", "values"}``."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike]):
        super().__init__()
        self.run_name = run_name
        from .telemetry.artifacts import ArtifactWriter

        self.path = os.path.join(logging_dir, run_name, "metrics.jsonl")
        self._fh = ArtifactWriter(self.path)

    @property
    def tracker(self):
        return self._fh

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._write({"event": "config", "values": _jsonable(values)})

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self._write({"event": "log", "step": step, "time": time.time(),
                     "values": _jsonable(values)})

    def _write(self, obj):
        self._fh.write_line(json.dumps(obj))

    @on_main_process
    def finish(self):
        self._fh.close()


class TensorBoardTracker(GeneralTracker):
    """Through ``torch.utils.tensorboard`` or ``tensorboardX``."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike], **kwargs):
        super().__init__()
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard

        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(_flatten_scalars(values), metric_dict={})
        self.writer.flush()
        try:
            import yaml

            with open(os.path.join(self.logging_dir, "hparams.yml"), "w") as outfile:
                yaml.dump(_jsonable(values), outfile)
        except Exception:
            with open(os.path.join(self.logging_dir, "hparams.json"), "w") as outfile:
                json.dump(_jsonable(values), outfile)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in _jsonable(values).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run_name = run_name
        self.run = wandb.init(project=self.run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, experiment_name: Optional[str] = None, logging_dir=None, **kwargs):
        super().__init__()
        import mlflow

        mlflow.set_experiment(os.environ.get("MLFLOW_EXPERIMENT_NAME", experiment_name))
        self.active_run = mlflow.start_run(**kwargs)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for name, value in list(values.items()):
            if len(str(value)) > mlflow.utils.validation.MAX_PARAM_VAL_LENGTH:
                del values[name]
        mlflow.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        mlflow.log_metrics({k: v for k, v in values.items() if isinstance(v, (int, float))},
                           step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from comet_ml import Experiment

        self.run_name = run_name
        self.writer = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.log_metric(k, v, step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.log_other(k, v, **kwargs)
            elif isinstance(v, dict):
                self.writer.log_metrics(v, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.end()


class AimTracker(GeneralTracker):
    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir=".", **kwargs):
        super().__init__()
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for key, value in values.items():
            self.writer.track(value, name=key, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, **kwargs):
        super().__init__()
        from clearml import Task

        current = Task.current_task()
        self._initialized_externally = current is not None
        self.task = current or Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)) and step is not None:
                clearml_logger.report_scalar(title=k, series=k, value=v, iteration=step,
                                             **kwargs)
            else:
                clearml_logger.report_single_value(name=k, value=v, **kwargs)

    @on_main_process
    def finish(self):
        if self.task and not self._initialized_externally:
            self.task.close()


class DVCLiveTracker(GeneralTracker):
    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(_flatten_scalars(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            self.live.log_metric(k, v, **kwargs)

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "jsonl": JSONLTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
}


def filter_trackers(log_with, logging_dir=None) -> list:
    """``log_with`` ("all", names, ``LoggerType``s or tracker instances)
    -> the trackers to build: a name whose package is missing is skipped
    with a warning, an unknown one raises, and one that writes files
    needs ``logging_dir``."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    available = get_available_trackers()
    loggers = []
    if "all" in log_with or LoggerType.ALL in log_with:
        loggers = list(available)
    else:
        for item in log_with:
            if isinstance(item, GeneralTracker):
                loggers.append(item)
                continue
            try:
                item = LoggerType(str(item))
            except ValueError:
                raise ValueError(
                    f"Unknown tracker {item!r}; choose from {[str(t) for t in available]}"
                ) from None
            if item not in available:
                logger.warning("Tried adding logger %s but package is not installed; skipping.",
                               item)
            else:
                loggers.append(item)
    for t in loggers:
        if (not isinstance(t, GeneralTracker)
                and LOGGER_TYPE_TO_CLASS[t.value].requires_logging_directory
                and logging_dir is None):
            raise ValueError(f"Logging with `{t}` requires a `logging_dir` (set project_dir)")
    return loggers


def resolve_trackers(log_with, project_name: str, logging_dir=None,
                     init_kwargs: Optional[dict] = None) -> list:
    """Build the trackers :func:`filter_trackers` chose; ``init_kwargs``
    maps a tracker's name to its constructor's keyword arguments."""
    init_kwargs = init_kwargs or {}
    trackers = []
    for t in log_with:
        if isinstance(t, GeneralTracker):
            trackers.append(t)
            continue
        cls = LOGGER_TYPE_TO_CLASS[t.value]
        kw = init_kwargs.get(t.value, {})
        if cls.requires_logging_directory:
            trackers.append(cls(project_name, logging_dir, **kw))
        else:
            trackers.append(cls(project_name, **kw))
    return trackers


def _jsonable(values: dict) -> dict:
    """Scalars of tensors and numpy values as Python numbers, arrays as
    lists, nested dicts alike."""
    import numpy as np

    out = {}
    for k, v in values.items():
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[k] = v.item()
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        elif hasattr(v, "tolist") and not isinstance(v, (int, float, str, bool)):
            out[k] = (v.detach().cpu() if hasattr(v, "detach") else np.asarray(v)).tolist()
        else:
            out[k] = v
    return out


def _flatten_scalars(values: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_scalars(v, prefix=key + "/"))
        elif isinstance(v, (int, float, str, bool)):
            flat[key] = v
        else:
            flat[key] = str(v)
    return flat
