"""Helpers shared by the port's tests (no tests here): compare nested
(Named)tuples of arrays from the JAX package and the port leaf by leaf."""

import numpy as np


def named_leaves(tree, prefix=""):
    """(dotted field name, numpy leaf) of nested (Named)tuples."""
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", range(len(tree)))
        for f, sub in zip(fields, tree):
            yield from named_leaves(sub, f"{prefix}{f}.")
    else:
        yield prefix.rstrip("."), np.asarray(tree)


def assert_same(want, got, where=""):
    """Every leaf of ``got`` equals ``want``'s, with the same dtype and shape."""
    for (name, w), (_, g) in zip(named_leaves(want), named_leaves(got),
                                 strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, (where, name, g.dtype,
                                                           w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


def to_torch(x, device="cpu"):
    """A numpy or JAX array as a torch tensor; bfloat16 keeps its bits."""
    import torch

    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def bf16_bits(t):
    """The int16 bit patterns of a bf16 torch tensor or array, as numpy."""
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().view(torch.int16).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.int16)
