"""arendur_tpu_torch: the PyTorch + CUDA port of arendur_tpu.

Everything the JAX package does, on NVIDIA H100s: the wavefront path
tracer (the fused bounce shade, the hit / texel lookup / shade split on
textured scenes, the composed bounce; instanced meshes; the BVH walk and
the brute force), the Whitted and bidirectional renderers, the
material-fitting train step, and the sharded render and train step over
``torch.distributed``, one process per card (``parallel/``).  Its
hand-written Hopper kernels (``arendur_tpu_torch/kernels``) are closest
hit, shadow any-hit, the bounce shade and its backward, the two halves
of the textured bounce and the two BSDF slot sweeps.  The JAX package
``arendur_tpu`` stays the reference: every module here keeps its
counterpart's name and layout, and the tests hold each one against it on
the CPU.

Dispatch is by the device of the input tensor: a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain PyTorch version
(public as ``*_reference``).  This package never imports JAX.
"""

import numpy  # noqa: F401
import torch  # noqa: F401
