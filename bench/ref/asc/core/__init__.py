"""The frozen host-side core and plain step (see the package)."""
