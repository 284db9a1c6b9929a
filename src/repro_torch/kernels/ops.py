"""Public kernel surface of the port, with the reference's signatures
(``src/repro/kernels/ops.py``) minus its ``impl``/``block`` switches.

Dispatch goes by the device of the tensors: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel or
raises.  There is no switch that routes a CUDA tensor to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import inner_loop as _il
from repro_torch.kernels import round_tail as _rt
from repro_torch.kernels.fused_update import fused_update
from repro_torch.kernels.inner_loop import inner_loop_affine
from repro_torch.kernels.round_tail import (
    dual_from_uplink, fused_update_arena, round_tail, scaffold_cv,
)

# every kernel of the port, for launch accounting (chip_smoke.py), in the
# order of the kernel table (ROADMAP.md)
KERNELS = (_il.KERNEL, _rt.ROUND_TAIL, _rt.DUAL_FROM_UPLINK, _rt.FUSED_UPDATE_ARENA,
           _rt.SCAFFOLD_CV, _fu.KERNEL)


def affine_inner_fits(width: int) -> bool:
    """Width gate of ``inner_loop_affine`` (its shared-memory rule)."""
    return _il.fits(width)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "affine_inner_fits", "dual_from_uplink", "fused_update",
    "fused_update_arena", "inner_loop_affine", "launches", "reset_launches",
    "round_tail", "scaffold_cv",
]
