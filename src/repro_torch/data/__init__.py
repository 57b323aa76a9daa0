"""Data sources of the port (counterpart of ``repro/data``)."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
