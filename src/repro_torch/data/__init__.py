"""Data pipelines of the port."""
from .pipeline import TokenDataset

__all__ = ["TokenDataset"]
