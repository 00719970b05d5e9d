"""kwok_tpu_torch: the Stage-FSM simulator on PyTorch and CUDA.

The same vectorized Stage finite-state machine as ``kwok_tpu`` (one
row per simulated Pod/Node in a device-resident struct-of-arrays,
advanced by an integer-exact tick), run by hand-written CUDA kernels
for Hopper (``csrc/``) on an NVIDIA GPU.  Every kernel keeps a plain
PyTorch version beside it, used for tensors on the CPU.  The package
imports neither jax nor ``kwok_tpu``: the host-side modules it needs
(stage API, kq, templates, compiler) are its own copies.
"""

__version__ = "0.1.0"
