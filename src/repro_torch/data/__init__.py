"""The synthetic token pipeline of the PyTorch port
(``pipeline.TokenStream``, ``pipeline.Prefetcher``)."""
from .pipeline import Prefetcher, TokenStream

__all__ = ["Prefetcher", "TokenStream"]
