"""The frozen guest kernel: its carry layout and batched service."""
from . import engine, state  # noqa: F401
