"""PyTorch/CUDA port of the ``repro`` package (GPDMM/AGPDMM, Zhang et al.
2021) for NVIDIA Hopper.

The layout mirrors ``src/repro`` module for module; ``repro`` stays the
reference each ported piece is tested against.  This package imports
``torch`` and never ``jax`` or anything of ``repro``.  Entry points that
create tensors take ``device=`` (default ``"cuda"``); everything else
follows its inputs' device, and every kernel wrapper dispatches on the
device of the tensors it is given: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the hand-written kernel or raises.
"""
