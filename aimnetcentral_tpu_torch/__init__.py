"""AIMNet2 in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``aimnetcentral_tpu`` (JAX/Pallas).  It imports neither JAX nor
the JAX package; module names follow the JAX package so that each port has
an obvious counterpart there.  Covered so far: periodic energy, forces and
stress through :class:`~aimnetcentral_tpu_torch.calculators.AIMNet2Calculator`
on the binned (stencil) engine, with the ConvSV stencil contraction and its
adjoint as CUDA kernels (``csrc/``).  See ROADMAP.md for what is still to come.
"""

from aimnetcentral_tpu_torch.device import resolve_device  # noqa: F401
