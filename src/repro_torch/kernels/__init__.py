"""Packed arithmetic: plain PyTorch versions (``ref``), the CUDA kernels'
wrappers (``int4_matmul``, ``packed_matmul``), their build (``build``) and
the float-in/float-out dispatch (``ops``)."""
