"""Hand-written Hopper kernels of the port, one folder each
(``<name>/{kernel,ops,ref}.py``) with CUDA C++ sources in ``csrc/``,
built by ``build.py`` on first use. Ported so far: ``window_agg``."""
