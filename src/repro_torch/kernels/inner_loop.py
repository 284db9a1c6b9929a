"""The whole K-step eq. (20) inner loop for affine gradient oracles as one
CUDA kernel (``csrc/inner_loop.cu``); the port of
``src/repro/kernels/inner_loop.py::inner_loop_affine_pallas``.

For g_i(x) = H_i x - (c_i + off_i) the kernel runs all K steps

    x <- x - step_i (g + rho (x - x_s) + lam_i)

and returns (x_K, mean_k x_k).  Two routes on the card, chosen by ``route``
from the width alone before the launch (not a fallback: each route is the
kernel for its widths, and a launch the card refuses raises):

  * ``"resident"``  W <= 640: a thread-block cluster of ``cluster_size(W)``
                    blocks per client, each warp holding its rows of H_i in
                    registers for all K steps (at most ``FRAGMENT_FLOATS`` a
                    thread), so H is read from device memory once; the
                    blocks pass each step's x to one another through
                    distributed shared memory, and each persistent cluster
                    stages its next client in shared memory while it steps
                    (``resident_smem_bytes``);
  * ``"stream"``    wider (W = 1024 holds 4 MiB of H a client): one block
                    per client keeps the client's rows in shared memory
                    (``SMEM_ROWS`` rows of W f32) and re-reads H from device
                    memory on every step.

``last_route`` records the route of the last call on the card.  ``fits`` is
the width rule of the two routes together (the streaming route takes every
width the resident route takes) and replaces the TPU's 8 MiB VMEM gate
(``inner_loop.fits_vmem``).

Operands on the card: H and c f32; x0 f32 or bf16, and x_s, lam and off
each f32 or bf16.  The kernel upcasts every operand on load, runs the K
steps in f32 and rounds x_K and x_bar once, to x0's dtype, as the Pallas
kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _args, _build, ref
from repro_torch.kernels._build import F, I, P, Kernel
from repro_torch.kernels.fused_update import LANES

SMEM_ROWS = 6  # streaming route: x, x sum, c + off, x_s, lam, g
SMEM_CAP_BYTES = 232_448  # the most dynamic shared memory one block may use
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is past the portable 8: a non-portable cluster
RES_WARPS = 16  # warps of a resident block (512 threads, one block an SM)
FRAGMENT_FLOATS = 64  # the most of H's slab a resident thread holds in registers
HEAD_BYTES = 32  # the mbarriers: the staging area's, one per copy of x (kHeadBytes)

KERNEL = Kernel(
    "inner_loop_affine", "inner_loop.cu", "launch_inner_loop_affine",
    # x0 H c xs lam off step_arr step rho inv_k K m W dtype xs_dt lam_dt off_dt
    # resident_route x_out xbar_out dev stream
    [P, P, P, P, P, P, P, F, F, F, I, I, I, I, I, I, I, I, P, P, I, P],
    replaces="src/repro/kernels/inner_loop.py:100",
)
# W dtype device out
CLUSTERS_SYMBOL = "inner_loop_resident_clusters"
CLUSTERS_ARGTYPES = [I, I, I, ctypes.POINTER(ctypes.c_int)]

last_route: str | None = None


def smem_bytes(width: int) -> int:
    """The streaming route's shared memory: its rows."""
    return 4 * SMEM_ROWS * width


def fits(width: int) -> bool:
    """Can the kernel take arena width ``width`` (on either route)?"""
    return width % LANES == 0 and smem_bytes(width) <= SMEM_CAP_BYTES


def rows_per_warp(width: int, cluster: int) -> int:
    """Rows of H a resident warp owns: the block's W / C rows over 16 warps."""
    return -(-(width // cluster) // RES_WARPS)


def fragment_floats(width: int, cluster: int) -> int:
    """f32 registers a resident thread holds H's slab in: its warp's rows,
    W / 32 columns of each (W / 128 float4)."""
    return rows_per_warp(width, cluster) * (width // LANES) * 4


def cluster_size(width: int) -> int | None:
    """Blocks per client on the resident route: the fewest that keep a
    thread's fragment of the slab within ``FRAGMENT_FLOATS``; None where no
    cluster of at most 16 does."""
    for c in CLUSTER_SIZES:
        if width % (8 * c) == 0 and fragment_floats(width, c) <= FRAGMENT_FLOATS:
            return c
    return None


def resident_smem_bytes(width: int) -> int:
    """The resident route's shared memory a block: the mbarriers, the
    staging area for the next client (its slab of W / C rows of H, its x0
    row and its c, off and lam rows) and two copies of x."""
    rows = width // cluster_size(width)
    return HEAD_BYTES + 4 * (rows * width + 3 * width + 3 * rows)


def route(width: int) -> str:
    """``"resident"`` where some cluster keeps a thread's share of H within
    its registers and the staged slab within shared memory, ``"stream"``
    for the wider widths the streaming route takes; raises for the rest."""
    if not fits(width):
        raise ValueError(f"inner_loop_affine: width {width} is not a multiple of {LANES} or "
                         f"its {smem_bytes(width)} B of rows exceed {SMEM_CAP_BYTES} B of "
                         f"shared memory")
    if cluster_size(width) and resident_smem_bytes(width) <= SMEM_CAP_BYTES:
        return "resident"
    return "stream"


def inner_loop_affine(x0, H, c, x_s, lam, step, rho, K: int, *, off=None):
    """x0, c, lam, off: (m, W); H: (m, W, W); x_s: (W,); ``lam``/``off``
    may be None; ``step`` a Python float or an (m,) f32 tensor.  Returns
    (x_K, x_bar) in x0's dtype."""
    global last_route
    name = KERNEL.name
    if _args.on_cpu(name, x0):
        return ref.inner_loop_affine_ref(x0, H, c, x_s, lam, step, rho, K, off=off)
    path = route(x0.shape[1])
    x_K, x_bar = launch(x0, H, c, x_s, lam, step, rho, K, off=off, path=path)
    last_route = path
    return x_K, x_bar


def launch(x0, H, c, x_s, lam, step, rho, K: int, *, off=None, path: str):
    """Check the CUDA operands and launch route ``path``, ``"resident"``
    (with the cluster its width fixes) or ``"stream"``.
    ``inner_loop_affine`` passes the route its width selects; the streaming
    route at a resident width is there to hold the two routes' bits
    against each other."""
    if path not in ("resident", "stream"):
        raise ValueError(f"inner_loop_affine: route {path!r}, not resident or stream")
    name = KERNEL.name
    m, w = x0.shape
    dev, f32, rows = x0.device, (torch.float32,), tuple(_args.DTYPE_CODES)
    _args.check(name, "x0", x0, (m, w), rows, dev)
    _args.check(name, "H", H, (m, w, w), f32, dev)
    _args.check(name, "c", c, (m, w), f32, dev)
    _args.check(name, "x_s", x_s, (w,), rows, dev)
    if lam is not None:
        _args.check(name, "lam", lam, (m, w), rows, dev)
    if off is not None:
        _args.check(name, "off", off, (m, w), rows, dev)
    step_arr, step_f = _args.step_operand(name, step, m, dev)
    code = lambda t: 0 if t is None else _args.DTYPE_CODES[t.dtype]
    x_K = torch.empty_like(x0)
    x_bar = torch.empty_like(x0)
    KERNEL.launch(
        _args.ptr(x0), _args.ptr(H), _args.ptr(c), _args.ptr(x_s), _args.ptr(lam),
        _args.ptr(off), _args.ptr(step_arr), step_f, float(rho), 1.0 / K, int(K),
        m, w, code(x0), code(x_s), code(lam), code(off), int(path == "resident"),
        _args.ptr(x_K), _args.ptr(x_bar), *_args.stream_args(dev))
    return x_K, x_bar


def max_active_clusters(width: int) -> int:
    """How many f32 resident-route clusters (of ``cluster_size(width)``
    blocks) at ``width`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = getattr(_build.load(KERNEL.source), CLUSTERS_SYMBOL)
    fn.argtypes, fn.restype = CLUSTERS_ARGTYPES, ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(width, _args.DTYPE_CODES[torch.float32], torch.cuda.current_device(),
            ctypes.byref(out))
    if rc != 0:
        msg = _build.load(KERNEL.source).repro_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL.name}: occupancy query failed: {msg} ({rc})")
    return out.value
