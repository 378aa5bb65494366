"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (configs/, models/, kernels/, core/, serve/, launch/) and imports
nothing from it. Plain tensor code is PyTorch; the Pallas TPU kernels on
the ported path are hand-written CUDA kernels in ``kernels/csrc/``,
built with ``nvcc`` at first use (kernels/_build.py).
"""
