"""Physics verification tools (the counterparts of ``verification/``),
each run as ``python -m pinc_tpu_torch.verification.<name>``."""
