"""Hand-written CUDA kernels for Hopper (sm_90a), one directory each:
``<name>.cu`` (kernel + C launcher), ``ref.py`` (plain PyTorch version of
the same function) and ``ops.py`` (the public op: the plain version on
CPU tensors, the kernel on CUDA tensors).  ``build.py`` compiles the
sources at first use."""
