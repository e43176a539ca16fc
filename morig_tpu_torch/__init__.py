"""morig_tpu_torch — the PyTorch + CUDA port of morig_tpu for NVIDIA Hopper.

Same layout as `morig_tpu` (core/, kernels/, nn/, geometry/, pipelines/), so
each module's counterpart is found under the same name.  The JAX package is
the reference this port is held against; this package imports torch and
never jax.

Precision contract (the JAX package's inference contract): float32 matrix
products run in full float32, so TF32 is switched off for both matmuls and
cuDNN here, where every entry point passes.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
