"""The port's command line: ``python -m accelerate_tpu_torch.commands.serve
replica ...`` serves one engine over HTTP (``serve.py``)."""
