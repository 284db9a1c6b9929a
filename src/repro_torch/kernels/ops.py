"""Public kernel surface of the port, with the reference's signatures
(``src/repro/kernels/ops.py``) minus its ``impl``/``block`` switches.

Dispatch goes by the device of the tensors: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel or
raises.  There is no switch that routes a CUDA tensor to the plain version.
``ef21_update`` (kernels 7-8 with the per-leaf scales between them, one
launch on the card where the reference runs two kernels around plain
code), ``fused_update_leaves`` (the step of a whole tree in one launch,
with x_bar's running sum) and the cohort row movement over a table of
buffers (``row_gather_buffers``, ``row_scatter_buffers_`` in place,
``row_scatter_``; ``row_scatter`` and ``row_scatter_buffers`` copy first)
and the arena round's server step (``server_step``: ``client_mean``, then
``server_dual``, the dual with lam's column sum in its pass;
``round_tail_mean``, the round tail with the client mean in its pass),
the screen's keep mask in one launch (``screen_keep``) and SCAFFOLD's
full-arena server step (``scaffold_step``) are the port's own;
``attend_cache`` and ``wkv6_step`` (one decode token) are plain tensor
code in the reference and here.

Gradients through kernels 16-17 and ``lru_scan``.  A ctypes kernel is
invisible to autograd, so on the card ``flash_attention``, ``wkv6`` and
``lru_scan`` go through an ``autograd.Function`` (``FlashAttention``,
``Wkv6``, ``LruScan``) whenever a gradient or a ``torch.func`` transform
may reach them: its backward is a kernel too (16b ``flash_attention_bwd``,
17b ``wkv6_bwd``, ``lru_scan_bwd``), itself a Function so that the
backward can run under ``vmap``.  Each Function has an explicit vmap
rule that folds the vmapped dim into the kernel's batch dim ((m, B, S, H,
d) -> (m B, S, H, d); u (m, H, K) becomes one row of u a client), which is
how the rounds' ``vmap(grad(loss))`` reaches the kernels.  A CPU tensor
calls the plain version directly, with no Function on the path, so autograd
and ``torch.func.jvp`` differentiate it as before; nothing sends a CUDA
tensor to a plain backward.

Forward mode.  ``FlashAttention``, ``FlashAttentionBackward``, ``Wkv6``,
``Wkv6Backward``, ``LruScan`` and ``LruScanBackward`` have a ``jvp`` rule
whose tangent is a kernel too (16j ``flash_attention_jvp``, 16bj
``flash_attention_bwd_jvp``, 17j ``wkv6_jvp``, 17bj ``wkv6_bwd_jvp``,
``lru_scan_jvp``, ``lru_scan_bwd_jvp``), each called through a small
Function of its own with a vmap rule that folds the clients into the batch,
as the others do (u and u' one row a client, or each client's rows, as
``Wkv6``'s own rule folds u).
That is what ``--eta auto``'s curvature probe takes
(``core.autotune.estimate_L``: ``vmap(jvp(grad(loss)))``): the forward's
rule gives the tangents of o, y and the final state, and the backward
Function, run on those duals by the gradient, its own rule the tangents of
the gradients.  16j and 16bj form lse's tangent themselves, and 17j and
17bj the tangents of the chunk states: lse and the states are
non-differentiable, so none arrives.  ``Wkv6`` keeps its chunk states
whenever a gradient or a transform may reach it, since 17j reads them.  A
kernel launched inside one of these Functions may run while an oracle is a
jvp target (``_args.forward_mode_rule``); any other ctypes kernel still
raises there.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import _args, ref
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import inner_loop as _il
from repro_torch.kernels import lru_scan as _lr
from repro_torch.kernels import neighbor_reduce as _nr
from repro_torch.kernels import residual as _rs
from repro_torch.kernels import round_tail as _rt
from repro_torch.kernels import screen as _sc
from repro_torch.kernels import stale_mix as _sm
from repro_torch.kernels import wkv6 as _wk
from repro_torch.kernels.fused_update import (
    acc_mode_at, fused_update, fused_update_arena, fused_update_leaves,
)
from repro_torch.kernels.gather import row_gather as row_gather_buffers
from repro_torch.kernels.gather import row_scatter_ as row_scatter_buffers_
from repro_torch.kernels.inner_loop import inner_loop_affine
from repro_torch.kernels.neighbor_reduce import edge_flip, neighbor_reduce
from repro_torch.kernels.residual import residual_norm
from repro_torch.kernels.round_tail import (
    client_mean, dual_from_uplink, ef21_apply, ef21_rowmax, ef21_update, round_tail,
    round_tail_mean, scaffold_cv, scaffold_step, server_dual, server_step,
)
from repro_torch.kernels.screen import screen_keep, screen_uplink
from repro_torch.kernels.stale_mix import stale_mix

# every kernel of the port, for launch accounting (chip_smoke.py): the
# seventeen in the order of the kernel table (ROADMAP.md), then the round
# tail's variant with the client mean in its pass (kernel 2's), the
# server step's mean pass (kernel 3's), the EF21 uplink (kernels 7-8 in
# one pass), the screen with its keep rule (kernel 11's) and SCAFFOLD's
# server step (kernel 5's, two launches a call), the backward kernels 16b-17b,
# the RG-LRU's recurrence and its backward, kernels of the port's own, and the
# tangents (forward mode) of 16, 16b, the RG-LRU's pair, 17 and 17b
KERNELS = (_il.KERNEL, _rt.ROUND_TAIL, _rt.DUAL_FROM_UPLINK, _fu.ARENA_KERNEL,
           _rt.SCAFFOLD_CV, _fu.KERNEL, _rt.EF21_ROWMAX, _rt.EF21_APPLY, _ga.ROW_GATHER,
           _ga.ROW_SCATTER, _sc.SCREEN_UPLINK, _sm.STALE_MIX, _rs.RESIDUAL_NORM,
           _nr.NEIGHBOR_REDUCE, _nr.EDGE_FLIP, _fa.FLASH_ATTENTION, _wk.WKV6,
           _rt.ROUND_TAIL_MEAN, _rt.CLIENT_MEAN, _rt.EF21_UPDATE, _sc.SCREEN_KEEP,
           _rt.SCAFFOLD_STEP, _fa.FLASH_ATTENTION_BWD, _wk.WKV6_BWD, _lr.LRU_SCAN,
           _lr.LRU_SCAN_BWD, _fa.FLASH_ATTENTION_JVP, _fa.FLASH_ATTENTION_BWD_JVP,
           _lr.LRU_SCAN_JVP, _lr.LRU_SCAN_BWD_JVP, _wk.WKV6_JVP, _wk.WKV6_BWD_JVP)


def affine_inner_fits(width: int) -> bool:
    """Width gate of ``inner_loop_affine``: a width either of its routes takes."""
    return _il.fits(width)


# the plain per-leaf scales between kernels 7 and 8 (held against the card)
_ef21_row_scales = ref.ef21_row_scales_ref


def row_gather(arr, idx):
    """The (mc, W) cohort buffer arr[idx]: ``arr`` (m, W), ``idx`` (mc,)
    row ids in range (int32 or int64)."""
    return _ga.row_gather((arr,), idx)[0]


def row_scatter_(dst, idx, rows):
    """dst[idx[t]] = rows[t] in place (idx distinct); returns ``dst``."""
    return _ga.row_scatter_((dst,), idx, (rows,))[0]


def row_scatter_buffers(dsts, idx, rows) -> tuple:
    """The functional ``row_scatter_buffers_``: each buffer copied, then
    the copies scattered in one launch; ``dsts`` are not written."""
    return _ga.row_scatter_(tuple(d.clone(memory_format=torch.contiguous_format) for d in dsts),
                            idx, rows)


def row_scatter(dst, idx, rows):
    """``dst`` with row idx[t] replaced by rows[t] (idx distinct), as a new
    tensor (the reference's contract): a copy of ``dst``, then the in-place
    scatter of the cohort's rows."""
    return row_scatter_buffers((dst,), idx, (rows,))[0]


# ---------------------------------------------------------------------------
# kernels 16-17 and lru_scan with a gradient
# ---------------------------------------------------------------------------

def _grad_follows(*ts) -> bool:
    """True when autograd (eager, or ``torch.func.grad``) records these
    tensors, so that a backward can follow: the Function then keeps what
    its backward kernel reads (lse, the chunk states)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _transformed(*ts) -> bool:
    """True when a ``torch.func`` transform (vmap, grad) wraps one of these
    tensors: the ctypes launchers take plain tensors only, so the call goes
    through its Function, whose vmap rule unwraps them.  A private query
    (``torch._C._functorch``; checked on torch 2.11 and 2.13), used for
    this one test."""
    from torch._C import _functorch

    return any(t is not None and _functorch.is_functorch_wrapped_tensor(t) for t in ts)


def _batched(info, in_dims, *ts):
    """Each tensor with its vmapped dim moved to the front (expanded where
    it is not vmapped), so that all share the leading dim of ``info``."""
    m = info.batch_size
    return tuple(None if t is None else t.movedim(d, 0) if d is not None
                 else t.expand(m, *t.shape) for t, d in zip(ts, in_dims))


def _fold(t):
    """(m, B, ...) -> (m B, ...), contiguous (the kernel's batch dim)."""
    return None if t is None else t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def _unfold(t, m: int):
    return None if t is None else t.reshape(m, t.shape[0] // m, *t.shape[1:])


def _tangents(primals, tangents):
    """Each tangent, or zeros like its primal where the input carries none."""
    return tuple(torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents))


def _no_second_derivative(name: str, kernel: str):
    def backward(ctx, *grads):
        raise NotImplementedError(f"{name}: no second derivative ({kernel} has no backward)")
    return staticmethod(backward)


class FlashAttention(torch.autograd.Function):
    """Kernel 16 whose backward is kernel 16b and whose forward-mode rule is
    kernel 16j.  ``apply(q, k, v, causal, window, q_offset, keep) -> (o,
    lse)``: with ``keep`` the kernel also writes each query row's
    logsumexp and the Function saves what 16b and 16j read; without it (a
    transform but no gradient, as the eval loss under ``no_grad`` in
    ``vmap``) lse is None and nothing is saved.  The curvature probe takes
    the tangent of a gradient, so ``keep`` is on wherever 16j runs."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset, keep):
        with _args.forward_mode_rule():
            if keep:
                return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                           q_offset=q_offset, lse=True)
            return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset, keep = inputs
        o, lse = output
        ctx.keep = keep
        if keep:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.save_for_forward(q, k, v, o, lse)
            ctx.args = (causal, window, q_offset)
            ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        if not ctx.keep:
            raise RuntimeError("flash_attention: called without keep, so no backward")
        q, k, v, o, lse = ctx.saved_tensors
        return (*FlashAttentionBackward.apply(q, k, v, o, lse, do, *ctx.args),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, qt, kt, vt, *_):
        if not ctx.keep:
            raise RuntimeError("flash_attention: called without keep, so no lse for its "
                               "forward-mode rule")
        q, k, v, _o, lse = ctx.saved_tensors
        ot, _ = FlashAttentionJvp.apply(q, k, v, lse, *_tangents((q, k, v), (qt, kt, vt)),
                                        *ctx.args)
        return ot, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset, keep):
        q, k, v = (_fold(t) for t in _batched(info, in_dims[:3], q, k, v))
        o, lse = FlashAttention.apply(q, k, v, causal, window, q_offset, keep)
        m = info.batch_size
        return (_unfold(o, m), _unfold(lse, m)), (0, None if lse is None else 0)


class FlashAttentionBackward(torch.autograd.Function):
    """Kernel 16b as a Function, so that it runs under ``vmap``; its
    forward-mode rule is kernel 16bj, and it has no backward of its own."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, q_offset):
        with _args.forward_mode_rule():
            return _fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=causal,
                                           window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[6:]
        ctx.save_for_forward(*inputs[:6])

    backward = _no_second_derivative("flash_attention", "kernel 16b")

    @staticmethod
    def jvp(ctx, qt, kt, vt, ot, _lset, dot, *_):
        # lse is non-differentiable (FlashAttention marks it): no tangent of
        # it arrives, and 16bj forms lse' from q', k' itself
        q, k, v, o, lse, do = ctx.saved_tensors
        tangents = _tangents((q, k, v, o, do), (qt, kt, vt, ot, dot))
        return FlashAttentionBwdJvp.apply(q, k, v, o, lse, do, *tangents, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, q_offset):
        folded = (_fold(t) for t in _batched(info, in_dims[:6], q, k, v, o, lse, do))
        grads = FlashAttentionBackward.apply(*folded, causal, window, q_offset)
        return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


class FlashAttentionJvp(torch.autograd.Function):
    """Kernel 16j as a Function, so that ``FlashAttention``'s forward-mode
    rule runs under ``vmap``: ``apply(q, k, v, lse, q', k', v', causal,
    window, q_offset) -> (o', lse')``."""

    @staticmethod
    def forward(q, k, v, lse, qt, kt, vt, causal, window, q_offset):
        with _args.forward_mode_rule():
            return _fa.flash_attention_jvp(q, k, v, lse, qt.contiguous(), kt.contiguous(),
                                           vt.contiguous(), causal=causal, window=window,
                                           q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("flash_attention_jvp", "kernel 16j")

    @staticmethod
    def vmap(info, in_dims, q, k, v, lse, qt, kt, vt, causal, window, q_offset):
        folded = (_fold(t) for t in _batched(info, in_dims[:7], q, k, v, lse, qt, kt, vt))
        ot, lse_t = FlashAttentionJvp.apply(*folded, causal, window, q_offset)
        m = info.batch_size
        return (_unfold(ot, m), _unfold(lse_t, m)), (0, 0)


class FlashAttentionBwdJvp(torch.autograd.Function):
    """Kernel 16bj as a Function, so that ``FlashAttentionBackward``'s
    forward-mode rule runs under ``vmap``: ``apply(q, k, v, o, lse, do, q',
    k', v', o', do', causal, window, q_offset) -> (dq', dk', dv')``."""

    @staticmethod
    def forward(q, k, v, o, lse, do, qt, kt, vt, ot, dot, causal, window, q_offset):
        with _args.forward_mode_rule():
            return _fa.flash_attention_bwd_jvp(
                q, k, v, o, lse, do.contiguous(), *(t.contiguous() for t in (qt, kt, vt, ot, dot)),
                causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("flash_attention_bwd_jvp", "kernel 16bj")

    @staticmethod
    def vmap(info, in_dims, *args):
        tensors, rest = args[:11], args[11:]
        folded = (_fold(t) for t in _batched(info, in_dims[:11], *tensors))
        grads = FlashAttentionBwdJvp.apply(*folded, *rest)
        return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


class Wkv6(torch.autograd.Function):
    """Kernel 17 whose backward is kernel 17b and whose forward-mode rule is
    kernel 17j.  ``apply(r, k, v, w, u, s0) -> (y, s_final, states)``; u
    (H, K) or one row per group of batch rows (n, H, K).  The Function keeps
    the states passed between chunks (None on the CPU, whose plain versions
    recompute them) and saves what 17b and 17j read."""

    @staticmethod
    def forward(r, k, v, w, u, s0):
        with _args.forward_mode_rule():
            return _wk.wkv6(r, k, v, w, u, s0, keep_states=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _y, s_out, states = output
        ctx.save_for_backward(*inputs, s_out, states)
        ctx.save_for_forward(*inputs, s_out, states)
        if states is not None:
            ctx.mark_non_differentiable(states)

    @staticmethod
    def jvp(ctx, rt, kt, vt, wt, ut, s0t):
        r, k, v, w, u, s0, _s_out, states = ctx.saved_tensors
        primals = (r, k, v, w, u, s0)
        yt, s_out_t = Wkv6Jvp.apply(*primals, states,
                                    *_tangents(primals, (rt, kt, vt, wt, ut, s0t)))
        return yt, s_out_t, None

    @staticmethod
    def backward(ctx, dy, ds_final, _dstates):
        r, k, v, w, u, s0, s_out, states = ctx.saved_tensors
        return Wkv6Backward.apply(r, k, v, w, u, s0, s_out, states, dy, ds_final)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0):
        m = info.batch_size
        r, k, v, w, u, s0 = _batched(info, in_dims, r, k, v, w, u, s0)
        u = u.contiguous() if u.ndim == 3 else _fold(u)  # one row of u a client, or its n rows
        y, s_out, states = Wkv6.apply(*(_fold(t) for t in (r, k, v, w)), u, _fold(s0))
        states = None if states is None else states.reshape(m, -1)
        return (_unfold(y, m), _unfold(s_out, m), states), (0, 0, None if states is None else 0)


class Wkv6Backward(torch.autograd.Function):
    """Kernel 17b as a Function, so that it runs under ``vmap``; its
    forward-mode rule is kernel 17bj, and it has no backward of its own."""

    @staticmethod
    def forward(r, k, v, w, u, s0, s_out, states, dy, ds_final):
        with _args.forward_mode_rule():
            return _wk.wkv6_bwd(r, k, v, w, u, s0, s_out, states, dy.contiguous(),
                                None if ds_final is None else ds_final.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    backward = _no_second_derivative("wkv6", "kernel 17b")

    @staticmethod
    def jvp(ctx, rt, kt, vt, wt, ut, s0t, _s_out_t, _states_t, dyt, ds_final_t):
        # the forward's states are non-differentiable (Wkv6 marks them) and
        # 17bj forms the tangents of every state itself, s_out's included
        r, k, v, w, u, s0, s_out, states, dy, ds_final = ctx.saved_tensors
        primals = (r, k, v, w, u, s0, dy)
        tangents = _tangents(primals, (rt, kt, vt, wt, ut, s0t, dyt))
        if ds_final is None:
            ds_final_t = None
        return Wkv6BwdJvp.apply(*primals[:6], s_out, states, dy, ds_final, *tangents,
                                ds_final_t)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0, s_out, states, dy, ds_final):
        m = info.batch_size
        ts = _batched(info, in_dims, r, k, v, w, u, s0, s_out, states, dy, ds_final)
        r, k, v, w, u, s0, s_out, states, dy, ds_final = ts
        shared_rows = u.ndim == 3  # a (H, K) u each client: one row of u a client
        u = u.contiguous() if shared_rows else _fold(u)
        states = None if states is None else states.reshape(-1)
        dr, dk, dv, dw, du, ds0 = Wkv6Backward.apply(
            *(_fold(t) for t in (r, k, v, w)), u, _fold(s0), _fold(s_out), states,
            _fold(dy), _fold(ds_final))
        du = du if shared_rows else _unfold(du, m)
        return ((_unfold(dr, m), _unfold(dk, m), _unfold(dv, m), _unfold(dw, m), du,
                 _unfold(ds0, m)), (0,) * 6)


class Wkv6Jvp(torch.autograd.Function):
    """Kernel 17j as a Function, so that ``Wkv6``'s forward-mode rule runs
    under ``vmap``: ``apply(r, k, v, w, u, s0, states, r', k', v', w', u',
    s0') -> (y', s_final')``."""

    @staticmethod
    def forward(r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t):
        with _args.forward_mode_rule():
            return _wk.wkv6_jvp(r, k, v, w, u, s0, states,
                                *(t.contiguous() for t in (rt, kt, vt, wt, ut, s0t)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("wkv6_jvp", "kernel 17j")

    @staticmethod
    def vmap(info, in_dims, *args):
        m = info.batch_size
        r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t = _batched(info, in_dims, *args)
        u, ut = (x.contiguous() if x.ndim == 3 else _fold(x) for x in (u, ut))
        states = None if states is None else states.reshape(-1)
        yt, s_out_t = Wkv6Jvp.apply(*(_fold(t) for t in (r, k, v, w)), u, _fold(s0), states,
                                    *(_fold(t) for t in (rt, kt, vt, wt)), ut, _fold(s0t))
        return (_unfold(yt, m), _unfold(s_out_t, m)), (0, 0)


class Wkv6BwdJvp(torch.autograd.Function):
    """Kernel 17bj as a Function, so that ``Wkv6Backward``'s forward-mode rule
    runs under ``vmap``: ``apply(r, k, v, w, u, s0, s_out, states, dy,
    ds_final, r', k', v', w', u', s0', dy', ds_final') -> (dr', dk', dv',
    dw', du', ds0')``; ds_final and ds_final' may be None (zero)."""

    @staticmethod
    def forward(r, k, v, w, u, s0, s_out, states, dy, ds_final, rt, kt, vt, wt, ut, s0t, dyt,
                ds_final_t):
        with _args.forward_mode_rule():
            return _wk.wkv6_bwd_jvp(
                r, k, v, w, u, s0, s_out, states, dy.contiguous(),
                None if ds_final is None else ds_final.contiguous(),
                *(t.contiguous() for t in (rt, kt, vt, wt, ut, s0t, dyt)),
                None if ds_final_t is None else ds_final_t.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("wkv6_bwd_jvp", "kernel 17bj")

    @staticmethod
    def vmap(info, in_dims, *args):
        m = info.batch_size
        ts = _batched(info, in_dims, *args)
        r, k, v, w, u, s0, s_out, states, dy, ds_final = ts[:10]
        rt, kt, vt, wt, ut, s0t, dyt, ds_final_t = ts[10:]
        shared_rows = u.ndim == 3  # a (H, K) u each client: one row of u a client
        u, ut = (x.contiguous() if shared_rows else _fold(x) for x in (u, ut))
        states = None if states is None else states.reshape(-1)
        grads = Wkv6BwdJvp.apply(*(_fold(t) for t in (r, k, v, w)), u, _fold(s0), _fold(s_out),
                                 states, _fold(dy), _fold(ds_final),
                                 *(_fold(t) for t in (rt, kt, vt, wt)), ut, _fold(s0t),
                                 _fold(dyt), _fold(ds_final_t))
        drt, dkt, dvt, dwt, dut, ds0t = grads
        dut = dut if shared_rows else _unfold(dut, m)
        return ((_unfold(drt, m), _unfold(dkt, m), _unfold(dvt, m), _unfold(dwt, m), dut,
                 _unfold(ds0t, m)), (0,) * 6)


class LruScan(torch.autograd.Function):
    """``lru_scan`` whose backward is ``lru_scan_bwd`` and whose forward-mode
    rule is ``lru_scan_jvp``.  ``apply(a, b, h0, keep) -> (y, h_last)``:
    with ``keep`` the Function saves a, h0 and the states y, which the
    backward reads; without it (a transform but no gradient) nothing is
    saved for a backward."""

    @staticmethod
    def forward(a, b, h0, keep):
        with _args.forward_mode_rule():
            return _lr.lru_scan(a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _, h0, keep = inputs
        ctx.keep = keep
        if keep:
            ctx.save_for_backward(a, h0, output[0])
        ctx.save_for_forward(a, h0, output[0])

    @staticmethod
    def backward(ctx, dy, dh_last):
        if not ctx.keep:
            raise RuntimeError("lru_scan: called without keep, so no backward")
        a, h0, y = ctx.saved_tensors
        return (*LruScanBackward.apply(a, y, h0, dy, dh_last), None)

    @staticmethod
    def jvp(ctx, at, bt, h0t, _keep):
        a, h0, y = ctx.saved_tensors
        return LruScanJvp.apply(a, y, h0, *_tangents((a, a, h0), (at, bt, h0t)))

    @staticmethod
    def vmap(info, in_dims, a, b, h0, keep):
        a, b, h0 = (_fold(t) for t in _batched(info, in_dims[:3], a, b, h0))
        y, h_last = LruScan.apply(a, b, h0, keep)
        m = info.batch_size
        return (_unfold(y, m), _unfold(h_last, m)), (0, 0)


class LruScanBackward(torch.autograd.Function):
    """``lru_scan_bwd`` as a Function, so that it runs under ``vmap``; its
    forward-mode rule is ``lru_scan_bwd_jvp``, and it has no backward of its
    own."""

    @staticmethod
    def forward(a, y, h0, dy, dh_last):
        with _args.forward_mode_rule():
            return _lr.lru_scan_bwd(a, y, h0, dy.contiguous(), dh_last.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    backward = _no_second_derivative("lru_scan", "lru_scan_bwd")

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        return LruScanBwdJvp.apply(*primals, *_tangents(primals, tangents))

    @staticmethod
    def vmap(info, in_dims, a, y, h0, dy, dh_last):
        folded = (_fold(t) for t in _batched(info, in_dims, a, y, h0, dy, dh_last))
        grads = LruScanBackward.apply(*folded)
        return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


class LruScanJvp(torch.autograd.Function):
    """``lru_scan_jvp`` as a Function, so that ``LruScan``'s forward-mode rule
    runs under ``vmap``: ``apply(a, y, h0, a', b', h0') -> (y', h_last')``."""

    @staticmethod
    def forward(a, y, h0, at, bt, h0t):
        with _args.forward_mode_rule():
            return _lr.lru_scan_jvp(a, y, h0, *(t.contiguous() for t in (at, bt, h0t)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("lru_scan_jvp", "lru_scan_jvp")

    @staticmethod
    def vmap(info, in_dims, *ts):
        yt, h_last_t = LruScanJvp.apply(*(_fold(t) for t in _batched(info, in_dims, *ts)))
        m = info.batch_size
        return (_unfold(yt, m), _unfold(h_last_t, m)), (0, 0)


class LruScanBwdJvp(torch.autograd.Function):
    """``lru_scan_bwd_jvp`` as a Function, so that ``LruScanBackward``'s
    forward-mode rule runs under ``vmap``: ``apply(a, y, h0, dy, dh_last,
    a', y', h0', dy', dh_last') -> (da', db', dh0')``."""

    @staticmethod
    def forward(*ts):
        with _args.forward_mode_rule():
            return _lr.lru_scan_bwd_jvp(*(t.contiguous() for t in ts))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    backward = _no_second_derivative("lru_scan_bwd_jvp", "lru_scan_bwd_jvp")

    @staticmethod
    def vmap(info, in_dims, *ts):
        grads = LruScanBwdJvp.apply(*(_fold(t) for t in _batched(info, in_dims, *ts)))
        return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal: bool = True,
                    window=None, q_offset=None):
    """Causal (optionally sliding-window) GQA attention, kernel 16.

    q (B, Sq, H, hd); k (B, Sk, Hkv, hd); v (B, Sk, Hkv, vd).  Without
    positions the keys sit at 0..Sk-1 and the queries at q_offset (default
    0) onwards: the model path, with no host read.  Explicit ``q_pos`` and
    ``k_pos`` (as ``ref.attention_ref`` takes them) run as they are on the
    CPU; on the card they must be contiguous, which is checked with a host
    read (``flash_attention.contiguous_offset``).  The reference's
    ``q_chunk``, ``k_chunk`` and ``causal_skip`` size its ``"xla"`` branch
    and have no counterpart here."""
    if q_pos is None:
        off = q_offset or 0
    elif _args.on_cpu(_fa.FLASH_ATTENTION.name, q):
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal, window=window)
    else:
        off = _fa.contiguous_offset(q_pos, k_pos, q.shape[1], k.shape[1])
    if q.device.type != "cpu":
        keep = _grad_follows(q, k, v)
        if keep:
            _fa.check_backward(q.shape[-1], v.shape[-1])
        if keep or _transformed(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window, off, keep)[0]
    return _fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)


def attend_cache(q, k_cache, v_cache, q_pos, k_pos, *, window=None):
    """Single-token decode attention against a (possibly ring-buffer) cache,
    plain tensor code as in the reference (``ops.py:161``).

    q (B, 1, H, hd); caches (B, S, Hkv, hd/vd); q_pos an int32 scalar
    tensor; k_pos (S,), -1 = empty slot."""
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(f32)) / math.sqrt(hd)
    valid = (k_pos >= 0) & (k_pos <= q_pos)
    if window is not None:
        valid = valid & (k_pos > q_pos - window)
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhv->bhgv", p, v_cache.to(f32))
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def wkv6(r, k, v, w, u, s0):
    """The RWKV-6 recurrence, kernel 17 (see ``kernels.wkv6``): (y,
    s_final).  On the card, inside ``Wkv6`` when a gradient or a transform
    may reach it, keeping the chunk states that 17b and 17j read."""
    if r.device.type != "cpu":
        if _grad_follows(r, k, v, w, u, s0) or _transformed(r, k, v, w, u, s0):
            y, s_out, _ = Wkv6.apply(r, k, v, w, u, s0)
            return y, s_out
    return _wk.wkv6(r, k, v, w, u, s0)


def lru_scan(a, b, h0):
    """The RG-LRU recurrence h_t = a_t h_{t-1} + b_t (``kernels.lru_scan``):
    a, b (B, S, D), h0 (B, D) -> (y (B, S, D), h_last (B, D) f32).  The
    reference's ``chunk`` sizes its associative scan and has no
    counterpart.  On the card, inside ``LruScan`` when a gradient or a
    transform may reach it."""
    if a.device.type != "cpu":
        keep = _grad_follows(a, b, h0)
        if keep or _transformed(a, b, h0):
            return LruScan.apply(a, b, h0, keep)
    return _lr.lru_scan(a, b, h0)


def wkv6_step(r1, k1, v1, w1, u, s):
    """One decode step of the recurrence, plain tensor code as in the
    reference (``ops.py:247``).  r1, k1, w1 (B, H, K); v1 (B, H, V); s
    (B, H, K, V).  Returns (y (B, H, V) in r1's dtype, s' f32)."""
    f32 = torch.float32
    rf, kf, vf, wf = (a.to(f32) for a in (r1, k1, v1, w1))
    sf = s.to(f32)
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, sf + u.to(f32)[None, :, :, None] * kv)
    return y.to(r1.dtype), wf[..., :, None] * sf + kv


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "FlashAttention", "FlashAttentionBackward", "FlashAttentionBwdJvp", "FlashAttentionJvp",
    "KERNELS", "LruScan", "LruScanBackward", "LruScanBwdJvp", "LruScanJvp", "Wkv6",
    "Wkv6Backward", "Wkv6BwdJvp", "Wkv6Jvp",
    "acc_mode_at", "affine_inner_fits", "attend_cache", "client_mean", "dual_from_uplink",
    "edge_flip", "ef21_apply", "ef21_rowmax", "ef21_update", "flash_attention", "fused_update",
    "fused_update_arena", "fused_update_leaves", "inner_loop_affine", "launches", "lru_scan",
    "neighbor_reduce", "reset_launches", "residual_norm", "round_tail", "round_tail_mean",
    "row_gather", "row_gather_buffers", "row_scatter", "row_scatter_", "row_scatter_buffers",
    "row_scatter_buffers_", "scaffold_cv", "scaffold_step", "screen_keep", "screen_uplink",
    "server_dual", "server_step", "stale_mix", "wkv6", "wkv6_step",
]
