"""Launch: process groups and meshes (``mesh``) and the command-line
training entry point (``train``) of the PyTorch port."""
