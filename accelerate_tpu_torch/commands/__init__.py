"""The port's command line, one module per command, each run as
``python -m accelerate_tpu_torch.commands.<name>``: ``serve`` (``replica``
serves one engine over HTTP, ``router`` the front door over several),
``loadtest`` (replay a workload spec, grade it), ``autoscale`` (the router
with the autoscaler attached) and ``incident`` (reconstruct incidents
from an artifact directory)."""
