"""The drivers a cell names (``workloads/<cell>.json``'s ``driver``):
``census`` and ``train``."""
