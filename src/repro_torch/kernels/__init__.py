"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

* ``ef_sign`` — checked wrappers of the three bucket EF-sign kernels, each
  with a launch count;
* ``ref``     — their plain PyTorch versions (the CPU path and the oracle);
* ``ops``     — the public entry points, dispatching on the tensor's device;
* ``_build``  — nvcc build at first use, loaded with ctypes.
"""
