"""PyTorch + CUDA port of the RNSG range-filtered ANN system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (each module sits at the same relative path) and is held against it
by tests that feed both the same inputs.  It imports ``torch``, ``numpy``
and the standard library only — never ``jax`` and never ``repro``.

Device rule: entry points (``RNSGIndex.build``/``load``,
``SearchSubstrate``) default to ``device="cuda"`` and raise when no card is
present; they never fall back to the CPU.  A kernel wrapper dispatches on
the device of the tensor it is given: a CPU tensor goes to the kernel's
plain PyTorch version, a CUDA tensor to the hand-written Hopper kernel
(``repro_torch/csrc``), which builds on first use or raises.

``f32`` means IEEE float32, as in the reference: TF32 is switched off here
for every float32 matmul (the exact KNN's distance product, the prune's
``einsum``) and for cuDNN.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
