"""Gradient compression for the slow cross-pod links, the counterpart of
the JAX package's ``repro/distributed/compression.py``.

At 2+ pods the data-parallel gradient all-reduce crosses the inter-pod
links; int8 quantize -> psum -> dequantize cuts those bytes 4x against
float32.  Per-tensor symmetric scaling, agreed by a max over the ranks
first, so every rank's int8 payload shares one scale and the sum is exact
in the quantized domain (int32); stochastic rounding keeps the compressed
mean unbiased.  The JAX package runs it under a ``shard_map`` manual over
the ``pod`` axis; here it runs over the ``pod`` group of a mesh of ranks
(``repro_torch.distributed.group``).  Stochastic rounding draws its
uniform dither from a ``torch.Generator`` (the JAX package's from a key,
``fold_in`` by leaf): leaf by leaf, in leaf order.  Neither trainer calls
these functions.
"""

from __future__ import annotations

import torch

from repro_torch import pytree


def _dither(shape, generator, device) -> torch.Tensor:
    """Uniform in [-0.5, 0.5) from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) - 0.5


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _round(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None):
    """Per-tensor symmetric int8 (round half to even, as ``jnp.round``), with
    stochastic rounding where a ``generator`` is given: (q int8, scale)."""
    scale = _scale(x.abs().max())
    y = x / scale
    if generator is not None:
        y = y + _dither(x.shape, generator, x.device)
    return _round(y), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def qdq(x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Quantize, then dequantize: the compression's error model on one
    rank."""
    return dequantize_int8(*quantize_int8(x, generator))


def int8_psum_tree(grads, group, generator: torch.Generator | None = None):
    """The mean of every rank's ``grads`` over ``group`` with an int8 wire
    format: each leaf in float32, its scale agreed by a max over the ranks,
    quantized (stochastically where a ``generator`` is given), summed in
    int32, dequantized and divided by the group's size.  Every rank gets
    the same bits."""
    def one(g):
        g = g.float()
        scale = _scale(group.pmax(g.abs().max()))
        y = g / scale
        if generator is not None:
            y = y + _dither(g.shape, generator, g.device)
        acc = group.psum(_round(y).to(torch.int32))
        return dequantize_int8(acc, scale) / float(group.world)

    return pytree.unflatten(grads, [one(g) for g in pytree.leaves(grads)])


def make_compressed_pod_allreduce(mesh, generator: torch.Generator | None = None):
    """tree -> the tree's mean over ``mesh``'s ``pod`` axis with the int8
    wire format (``mesh``: a ``repro_torch.distributed.group.MeshGroups``
    with a ``pod`` axis)."""
    assert "pod" in mesh.axis_names, mesh.axis_names
    group = mesh.group("pod")

    def allreduce(grads):
        return int8_psum_tree(grads, group, generator)

    return allreduce
