"""Packed arithmetic: plain PyTorch versions (``ref``), the CUDA kernels'
wrappers (``int4_matmul``, ``packed_matmul``, ``addpack_acc``,
``flash_attention``), their build (``build``) and the float-in/float-out
dispatch (``ops``)."""
