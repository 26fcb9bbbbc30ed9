"""PyTorch/CUDA port of the DSP-packing serving stack, for NVIDIA Hopper.

A second package beside ``repro`` (the JAX reference, which it never
imports).  Its layout mirrors the reference: ``kernels`` (the packed
arithmetic, its plain PyTorch versions and the hand-written CUDA kernels
under ``kernels/csrc``), ``core`` (the paper's packing, correction and
addition-packing arithmetic, quantizers, packed weight leaves, the
linear-layer funnel), ``models`` (config, registry, dense transformer),
``serving`` (sampling, scheduler, fixed-slot engine) and ``launch`` (the
serving CLI).  Entry points run on the card unless the caller passes
``device="cpu"``; they raise when CUDA is absent instead of falling back.
"""
