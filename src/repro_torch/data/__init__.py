"""Data sources of the port (counterpart of ``repro/data``)."""
from .pipeline import PackedBinReader, SyntheticLM, make_batch_fn

__all__ = ["PackedBinReader", "SyntheticLM", "make_batch_fn"]
