"""PyTorch and CUDA port of ``repro`` (the photonic DFA system).

The layout mirrors ``repro``: each module here is the counterpart of the
module of the same path there, which stays the reference the port is tested
against.  This package imports ``torch`` and never ``jax`` or ``repro``.

Slice 1 serves decoder-only LMs (qwen1.5-0.5b) through the photonic weight
bank, with the bank product in a hand-written CUDA kernel
(``kernels/csrc/photonic_matmul.cu``).  Entry points run on ``cuda`` unless
the caller passes another device, and raise when CUDA is absent.
"""
