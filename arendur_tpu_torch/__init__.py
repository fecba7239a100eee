"""arendur_tpu_torch: the PyTorch + CUDA port of arendur_tpu.

The wavefront path tracer's main path (one Cornell-box wave through
the fused bounce shade, or through the hit / texel lookup / shade
split on textured scenes) and its material-fitting train step on an
NVIDIA H100, with hand-written Hopper kernels for closest hit, shadow
any-hit, the bounce shade and its backward, and the two halves of the
textured bounce (``arendur_tpu_torch/kernels``).  The JAX package ``arendur_tpu``
stays the reference: every module here keeps its counterpart's name
and layout, and the tests hold each one against it on the CPU.

Dispatch is by the device of the input tensor: a CUDA tensor launches
the hand-written kernel, a CPU tensor runs the plain PyTorch version
(public as ``*_reference``).  This package never imports JAX.
"""

import numpy  # noqa: F401
import torch  # noqa: F401
