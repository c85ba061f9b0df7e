"""PyTorch / CUDA port of the ``repro`` package (the JAX reference beside it).

Same sub-package names as the reference so a reader finds the counterpart:
``models``, ``kernels``, ``core``, ``serving``, ``launch``, ``configs``. The
port imports ``torch`` only; its hand-written Hopper kernels live under
``kernels/csrc`` and are built at first use."""
