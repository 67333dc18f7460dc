"""Hand-written Hopper kernels of the port, one folder each
(``<name>/{kernel,ops,ref}.py``) with CUDA C++ sources in ``csrc/``,
built by ``build.py`` on first use: ``window_agg``, ``flash_attention``
and ``ssd_scan``, one for each Pallas kernel of the JAX package."""
