"""The port's run scripts (the counterparts of the repo's ``script/``),
each run as ``python -m pinc_tpu_torch.script.<name>``."""
