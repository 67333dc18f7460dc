"""Hand-written Hopper kernels of the port, one folder each
(``<name>/{kernel,ops,ref}.py``) with CUDA C++ sources in ``csrc/``,
built by ``build.py`` on first use: ``window_agg``, ``flash_attention``
and ``ssd_scan``, one for each Pallas kernel of the JAX package, and
``moe_dispatch``, the MoE's slot map and row gathers, which replace no
Pallas kernel (the JAX package's MoE is plain JAX).

``moe_dispatch`` is the exception to the layout: it has only
``kernel.py``, which holds the plain versions beside the launchers, and
registers no ``repro_torch::`` op. Its gathers run inside the MoE's own
``autograd.Function``s (``models/moe.py``), which give their gradients,
so a trace shows its kernels by name under the MoE's spans and under no
op of their own."""
