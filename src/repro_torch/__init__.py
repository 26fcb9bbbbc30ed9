"""PyTorch/CUDA port of the DSP-packing serving stack, for NVIDIA Hopper.

A second package beside ``repro`` (the JAX reference, which it never
imports).  Its layout mirrors the reference: ``kernels`` (the packed
arithmetic, its plain PyTorch versions and the hand-written CUDA kernels
under ``kernels/csrc``), ``core`` (the paper's packing, correction and
addition-packing arithmetic, quantizers, packed weight leaves, the
linear-layer funnel, fake-quant for training), ``models`` (config,
registry, every family's model), ``serving`` (sampling, schedulers, the
fixed-slot and continuous engines), ``tuning`` (plan search), ``optim``,
``data`` and ``checkpoint`` (training's optimizer, data stream and
checkpoints), ``runtime`` (fault tolerance, gradient compression) and
``launch`` (the serving and training CLIs, the train steps).  Entry
points run on the card unless the caller passes ``device="cpu"``; they
raise when CUDA is absent instead of falling back.
"""
