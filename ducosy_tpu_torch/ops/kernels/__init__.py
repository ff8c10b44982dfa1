"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper, a plain PyTorch version of the same
function, and a launch counter on the wrapper (``wrapper.launches``). A
wrapper runs the plain version only for tensors that lie on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""
