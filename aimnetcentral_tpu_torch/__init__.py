"""AIMNet2 in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``aimnetcentral_tpu`` (JAX/Pallas).  It imports neither JAX nor
the JAX package; module names follow the JAX package so that each port has
an obvious counterpart there.  Covered so far: energy, forces and stress
through :class:`~aimnetcentral_tpu_torch.calculators.AIMNet2Calculator` of
molecules, batches and small boxes on the indexed layout (host neighbor
lists), of gas-phase batches on the molecule-bin layout, and of large
periodic boxes and gas-phase clusters on the binned (stencil) engine, for
the flagship and the wB97M-D3 head sets and for released v2 artifacts
(``models/loader.py``: ``.pt`` files, Hugging Face directories, registry
names, behind the JAX package's trust boundary; ``train/export.py`` writes
them), with the ConvSV stencil contraction, the pair sweep and their
adjoints as CUDA kernels (``csrc/``); dense Hessians and Hessian-vector
products on the indexed layout (``calculators/derivatives.py``; the kernels'
wrappers are twice differentiable on the binned layouts), harmonic
vibrations, IR intensities and RRHO thermochemistry, transition-state
search and climbing-image NEB (``dynamics/``); MD and FIRE on the binned
and the indexed engines.  See ROADMAP.md for what is still to come.
"""

from aimnetcentral_tpu_torch.device import resolve_device  # noqa: F401
