"""PyTorch/CUDA port of ``gasfm_tpu`` for NVIDIA Hopper (H100).

The package mirrors the module names of the JAX package so that every
counterpart is easy to find, but it imports nothing of it (nor JAX): what it
needs from there it keeps as its own copy. Tensors live on an explicit
``device``; the entry points default to ``cuda`` and raise when no GPU is
present unless the caller asks for ``device="cpu"``.

The TPU's Pallas kernels on the forward path are hand-written CUDA C++
kernels here (``csrc/``), built with nvcc at first use and loaded with
ctypes (``ops/kernels/build.py``). A CPU tensor reaching a kernel wrapper
runs the wrapper's plain PyTorch version instead; a CUDA tensor launches the
kernel or raises.
"""
