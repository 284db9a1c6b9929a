"""Carry the reference's state across to the port: numpy arrays (or
anything ``np.asarray`` takes) in, tensors on ``device`` out, so both
packages compute from the same numbers.  Nothing here imports the
reference; it reads the fields it needs by name."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree_util as T
from repro_torch.core.quadratic import LeastSquares
from repro_torch.device import resolve


def tensor(a, device="cuda") -> torch.Tensor:
    """One array -> a tensor with the same dtype and values on ``device``
    (bf16 arrays carry across bit for bit)."""
    arr = np.asarray(a)
    dev = resolve(device)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def params(tree, device="cuda"):
    """An array, or any nesting of dicts, lists and tuples of arrays, ->
    the port's tree of the same structure (``None`` and empty containers
    kept)."""
    return T.tmap(lambda a: tensor(a, device), tree)


def model_params(tree, device="cuda"):
    """The reference's model parameters (``Model.init``'s nested tree:
    ``{"embed": ..., "stack": {"units": ..., "tail": [...]}, "final_norm":
    {}}``, MoE expert stacks (E, d, ff), the vision projector, codebook
    heads) or a model cache, -> the port's; each leaf keeps its dtype (bf16
    bit for bit, RG-LRU's f32 ``lam`` inside a bf16 tree)."""
    return params(tree, device)


def least_squares(ref, device="cuda") -> LeastSquares:
    """The reference's ``LeastSquares`` (its fields) -> the port's."""
    fields = ("AtA", "Atb", "btb", "evals", "evecs", "x_star", "f_star")
    return LeastSquares(**{f: tensor(getattr(ref, f), device) for f in fields},
                        L=float(ref.L), mu=float(ref.mu), reg=float(ref.reg))


def round_state(state: dict, device="cuda") -> dict:
    """A round state of any ported algorithm -> tensors.  Every entry but
    the round counter is an array or a tree of arrays: server trees
    (``x_s``, SCAFFOLD's ``c``), arena buffers (``lam_s``, ``x_c``,
    ``c_i``, FedSplit's ``z_s``, the async engine's ``stale_buf``,
    graph-PDMM's node and edge-dual arenas ``x`` and ``z``) or, on the
    pytree path, stacked trees; each keeps its dtype, so the stale
    slots' ``stale_age`` and ``stale_lat`` stay int32.  The round counter
    becomes an int32 scalar tensor."""
    out = {k: params(v, device) for k, v in state.items() if k != "round"}
    out["round"] = torch.tensor(int(np.asarray(state["round"])), dtype=torch.int32,
                                device=resolve(device))
    return out


def to_numpy(tree):
    """A tensor or a tree of tensors -> numpy (bf16 as its f32 value)."""
    def one(x):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return T.tmap(one, tree)
