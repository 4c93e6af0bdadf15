"""Checkpoint file names, the strings of the reference's
``utils/constants.py`` (so a checkpoint directory one side writes is the
directory the other reads), and the order of the device mesh's axes."""

# the device mesh's axes, outermost first (the reference's order): every
# mesh keeps all seven, size-1 axes included
MESH_AXIS_ORDER = ("replica", "stage", "data", "fsdp", "expert", "sequence", "tensor")

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
DATALOADER_STATE_NAME = "dl_state"
RNG_STATE_NAME = "random_states"
CUSTOM_STATE_PATTERN = "custom_checkpoint_{}"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
WEIGHTS_NAME = "model.msgpack"
