"""Configuration dataclasses of the port (``utils/dataclasses.py``),
``set_seed`` (``utils/random.py``), the batch-size finder and memory
helpers (``utils/memory.py``), ``tqdm`` and the tree operations
(``utils/operations.py``)."""

from .dataclasses import (AutocastKwargs, DataLoaderConfiguration, DistributedType,
                          GradientAccumulationPlugin, GradScalerKwargs, MixedPrecisionConfig,
                          PrecisionType, ProfileKwargs, ProjectConfiguration)
from .memory import (clear_device_cache, convert_bytes, find_executable_batch_size,
                     get_hbm_stats, release_memory, should_reduce_batch_size)
from .operations import (broadcast, broadcast_object_list, concatenate, convert_outputs_to_fp32,
                         convert_to_fp32, find_batch_size, find_device, gather, gather_object,
                         get_data_structure, get_shape, honor_type, initialize_tensors,
                         is_array_like, is_tensor_information, listify, pad_across_processes,
                         pad_input_tensors, recursively_apply, reduce, send_to_device,
                         slice_tensors)
from .random import set_seed
from .tqdm import tqdm

__all__ = ["AutocastKwargs", "DataLoaderConfiguration", "DistributedType", "GradScalerKwargs",
           "GradientAccumulationPlugin", "MixedPrecisionConfig", "PrecisionType",
           "ProfileKwargs", "ProjectConfiguration", "broadcast", "broadcast_object_list",
           "clear_device_cache", "concatenate", "convert_bytes", "convert_outputs_to_fp32",
           "convert_to_fp32", "find_batch_size", "find_device", "find_executable_batch_size",
           "gather", "gather_object", "get_data_structure", "get_hbm_stats", "get_shape",
           "honor_type", "initialize_tensors", "is_array_like", "is_tensor_information",
           "listify", "pad_across_processes", "pad_input_tensors", "recursively_apply",
           "reduce", "release_memory", "send_to_device", "set_seed",
           "should_reduce_batch_size", "slice_tensors", "tqdm"]
