"""The token data pipeline of the port (numpy; see ``pipeline.py``)."""
from .pipeline import DataConfig, TokenDataset, write_synthetic_corpus

__all__ = ["DataConfig", "TokenDataset", "write_synthetic_corpus"]
