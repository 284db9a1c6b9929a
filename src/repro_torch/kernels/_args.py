"""Operand checks shared by the kernel wrappers, and the device dispatch
rule: a CPU tensor runs the plain version, a CUDA tensor the kernel, and
any other device raises."""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType

_jvp = threading.local()


@contextlib.contextmanager
def jvp_target(what: str):
    """While ``what`` (an oracle) is differentiated with ``torch.func.jvp``,
    a wrapper handed a tensor off the CPU raises, naming ``what``: a
    ctypes kernel reads raw device pointers, so the jvp cannot see through
    it, and its tangent would come out wrong without a word.  A kernel
    launched inside a Function with a forward-mode rule
    (``forward_mode_rule``) is the exception."""
    stack = _jvp.__dict__.setdefault("stack", [])
    stack.append(what)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def forward_mode_rule():
    """Around the launches of an ``autograd.Function`` that has a forward-mode
    rule (``kernels.ops``: kernels 16, 16b, 17, 17b, the RG-LRU's pair and
    their tangent kernels): inside ``jvp_target`` its kernels launch, since
    the rule, not the ctypes call, carries the tangent."""
    depth = getattr(_jvp, "ruled", 0)
    _jvp.ruled = depth + 1
    try:
        yield
    finally:
        _jvp.ruled = depth


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel runs); raises for any other device, and inside
    ``jvp_target`` for any tensor off the CPU unless the launch comes from
    a Function with a forward-mode rule (``forward_mode_rule``)."""
    if t.device.type == "cpu":
        return True
    stack = getattr(_jvp, "stack", None)
    if stack and not getattr(_jvp, "ruled", 0):
        raise TypeError(
            f"{stack[-1]} launches the CUDA kernel {name}, and a ctypes kernel without a "
            f"forward-mode rule cannot be a torch.func.jvp target: give the oracle a "
            f"curvature_arena or affine_arena hook")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         f"(CPU runs the plain version, CUDA the kernel)")
    return False


def check(name: str, arg: str, t: torch.Tensor, shape, dtypes, device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``shape``, a dtype in
    ``dtypes``, contiguous and 16-byte aligned (float4 loads)."""
    if t.device != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_args(device: torch.device):
    """The trailing ``device, stream`` launcher arguments: PyTorch's current
    stream on ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    return ctypes.c_int(index), ctypes.c_void_p(stream)


def step_operand(name: str, step, m: int, device):
    """Split a stepsize into the launcher's (per-client array, scalar) pair:
    a Python number rides as the scalar, an (m,) f32 tensor as the array."""
    if torch.is_tensor(step) and step.ndim > 0:
        check(name, "step", step, (m,), (torch.float32,), device)
        return step, 0.0
    return None, float(step)


_workspaces: dict = {}


def workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, one buffer per device and
    stream, shared by every kernel that counts in it (the column walks'
    tile tickets, the screen's ticket, grid barrier and histograms).  The
    contract: the buffer is zero whenever no launch that uses it is
    running, so a kernel that writes into it sets it back to zero before
    its launch ends; launches on one stream run in order, so they can
    share it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _workspaces[key] = buf
    return buf
