"""The JAX package's three examples (``examples/`` at the root of the
repo) as the port's entry points, each run as
``python -m repro_torch.examples.<name>`` on the card, or with
``--device cpu`` on the CPU:

* :mod:`.quickstart` — Table 3, the rewrite report and Figure 4's C3;
* :mod:`.serve_demo` — prefill and greedy decode with the KV-cache engine;
* :mod:`.hooked_training` — a DDP train step whose gradient all-reduce is
  censused and compressed on the wire.

Each is a ``main(argv)`` over a function that returns what it prints.
"""
