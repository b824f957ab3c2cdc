"""The port's side of the C reference comparison (the counterpart of
``cbaseline/tpu_drift.py``): ``python -m pinc_tpu_torch.cbaseline.drift``."""
