"""Shared model building blocks: norms, RoPE, embeddings, init, dtypes.

The port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors under the reference's names, stacked on a leading layer axis; a
layer is a function ``(params, x, ...) -> y``.  Initialisation draws from
an explicit :class:`torch.Generator` (the reference's ``KeyGen`` of JAX
keys has no counterpart: the generator's state advances instead), so the
same seed gives the same weights on one device, not the reference's.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import numpy as np
import torch

Params = Any  # nested dict of torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def promote(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Cast tensors to their common dtype, as JAX promotes a mixed
    product (bf16 @ f32 is f32); torch's matmul and einsum refuse mixed
    dtypes instead."""
    dt = xs[0].dtype
    for x in xs[1:]:
        if x.dtype != dt:
            dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x.dtype == dt else x.to(dt) for x in xs)


@contextlib.contextmanager
def f32_accumulation():
    """bf16 products accumulate in f32, as XLA's do: cuBLAS may otherwise
    reduce a bf16 GEMM's split-K partial sums in bf16 (PyTorch's default
    ``allow_bf16_reduced_precision_reduction``), and the card's logits then
    drift from the CPU's.  The flag is process-wide; it is restored on
    exit."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


def clip(x: torch.Tensor, lo: float | None = None,
         hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (``jnp.maximum(x, lo)`` without ``hi``):
    ``torch.clamp``'s value, with JAX's gradient.  At a bound the gradient
    halves, as ``maximum`` / ``minimum`` split a tie evenly in both
    packages; ``torch.clamp`` passes it whole.  Online-softmax and decay
    terms sit on their upper bound wherever a running max does not move.
    The bounds are CPU 0-d tensors, which a CUDA op takes as scalar
    arguments: no device allocation and no fill launch."""
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype))
    return x


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion."""
    a, b = promote(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of two operands with JAX's dtype promotion."""
    a, b = promote(a, b)
    return torch.einsum(eq, a, b)


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------
class MetaGenerator:
    """A generator's stand-in on the meta device: a model initialised from
    it has its parameters' shapes and dtypes and no values (the dry run)."""

    device = torch.device("meta")


def _normal(gen, shape) -> torch.Tensor:
    """f32 N(0, 1) draws of ``shape`` on the generator's device."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, dtype, fan_in: int | None = None):
    """N(0, 1/fan_in) weights drawn in f32 on the generator's device."""
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / np.sqrt(max(fan, 1))
    return _normal(gen, shape).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return _normal(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(scale, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    v = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(dt) * scale


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["scale"] + p["bias"]


def make_norm(kind: str, d: int, dtype, device=None):
    if kind == "rmsnorm":
        return torch.ones((d,), dtype=dtype, device=device)
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(kind: str, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(..., S) int positions -> cos/sin of shape (..., S, head_dim/2), f32.

    Transcendentals: XLA's f32 ``pow`` and ``cos`` and torch's CPU and
    CUDA ones round differently, so ``pow``, ``cos`` and ``sin`` are taken
    in f64 and rounded once to f32 (the card and the CPU then agree); the
    division and the angle's product stay the reference's f32 steps.
    """
    half = head_dim // 2
    e = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), e.double()).float()
    ang = positions.float()[..., None] * freqs
    ang = ang.double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x, cos, sin):
    """x: (..., S, H, D).  cos/sin: (..., S, D/2) broadcast over heads.

    A bf16 ``x`` times the f32 angles is f32, as in the reference, and
    rounds back to ``x``'s dtype once at the end."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``, each
    op rounded to ``x``'s dtype (``torch.sigmoid`` rounds a bf16 result
    once, and then a quarter of bf16 values differ by an ulp)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, rounded after each step."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    return torch.tensor(v, dtype=dtype).item()


def _const(v: float, like: torch.Tensor) -> float:
    """A Python constant rounded to ``like``'s dtype, as a JAX weak-typed
    constant is (torch keeps a scalar operand in f32)."""
    return _rounded(v, like.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, in its own op
    order: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))``,
    each op rounded to ``x``'s dtype and the constants too (``F.gelu``
    rounds a bf16 result once)."""
    inner = x + _const(0.044715, x) * (x * x * x)
    t = torch.tanh(_const(float(np.sqrt(2.0 / np.pi)), x) * inner)
    return x * (_const(0.5, x) * (1 + t))


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu}[name]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, mask=None):
    """Token-level CE in fp32.  logits (B, S, V), labels (B, S) int.

    ``mask``: optional (B, S) 0/1 validity mask (pad tokens = 0).
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def count_params(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))
