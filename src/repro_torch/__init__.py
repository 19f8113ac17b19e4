"""PyTorch/CUDA port of the PACFL system (reference: the JAX package ``repro``).

Module paths mirror the reference one for one.  The port imports ``torch``
and ``numpy`` only; its four hand-written CUDA kernels (``csrc/``) are built
on first use and replace the reference's Pallas TPU kernels for proximity,
tsgemm, flash attention and the WKV recurrence.  Entry points take
``device=None``, which means ``"cuda"``.
"""
