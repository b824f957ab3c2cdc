"""The Python run framework (the counterpart of ``script/framework/``)."""
