"""Shared LM building blocks: parameter specs and their init, norms, RoPE,
the chunked cross-entropy.

Port of ``repro.models.common``.  Parameters are nested dicts of tensors,
as in the JAX package.  Where the JAX ``ParamBuilder`` draws each leaf from
a split ``jax.random`` key while it builds the tree, here the modules first
describe the tree (a :class:`Leaf` per parameter: shape and init) and
:func:`materialize` then draws every leaf from one explicit
``torch.Generator``, in the tree's order.  The two packages draw different
numbers from the same seed; the tests carry the JAX package's parameters
over (``convert.lm_params_from_numpy``) instead.  Each leaf also carries
the reference's logical axes (``Leaf.logical``), so the spec tree of the
JAX package's ``init_params`` comes from the same description
(``transformer.param_logical_axes``) and ``distributed.sharding``
resolves it on a mesh.  Norms are held whole on every rank; the
cross-entropy also takes a vocab-parallel unembedding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import tensor_parallel as tp


@dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, init and logical axes.  ``normal`` draws
    N(0, std²) with std = 1/sqrt(fan_in) (the first axis of a matrix, the
    only axis of a vector) unless ``std`` is given; ``zeros`` and ``ones``
    are constant.  ``logical``: one logical axis name (or None) a dimension,
    the reference's ``ParamBuilder.make`` argument (a
    ``distributed.sharding.PortAxes`` where the port cuts the leaf
    otherwise)."""
    shape: tuple[int, ...]
    init: str = "normal"
    std: float | None = None
    logical: tuple[str | None, ...] = field(kw_only=True)

    @property
    def normal_std(self) -> float:
        return 1.0 / math.sqrt(self.shape[0]) if self.std is None else self.std

    def stacked(self, count: int) -> "Leaf":
        """The same leaf for ``count`` layers (a leading ``layers`` axis);
        the std stays that of one layer's fan-in."""
        logical = (self.logical.stacked() if hasattr(self.logical, "port")
                   else ("layers", *self.logical))
        return Leaf((count, *self.shape), self.init, self.normal_std,
                    logical=logical)


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts and lists (the params, caches,
    specs; an unstacked group holds a list of layers)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _draw(leaf: Leaf, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=dev)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=dev)
    # in place: no second leaf-sized transient (the same products)
    return torch.randn(leaf.shape, generator=generator,
                       device=dev).mul_(leaf.normal_std)


def materialize(spec, generator: torch.Generator, dtype, device,
                keep=None):
    """Draw every leaf of ``spec`` in the tree's order on the generator's
    device; returns the tensor tree on ``device`` in ``dtype``.
    ``keep(leaf, tensor)``, when given, maps each tensor (e.g. to this
    rank's shard) before the next leaf is drawn."""
    def one(leaf):
        t = _draw(leaf, generator).to(device=device, dtype=dtype)
        return t if keep is None else keep(leaf, t)
    return tree_map(one, spec)


def make_norm(cfg, dim: int) -> dict:
    if cfg.norm_type == "layernorm":
        return {"scale": Leaf((dim,), "ones", logical=(None,)),
                "bias": Leaf((dim,), "zeros", logical=(None,))}
    return {"scale": Leaf((dim,), "zeros", logical=(None,))}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, norm_params: dict) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(x, norm_params["scale"], norm_params["bias"])
    return rmsnorm(x, norm_params["scale"])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, T, H, Dh) or (B, T, Dh); positions: (B, T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs            # (B, T, dh/2)
    if x.ndim == 4:
        angles = angles[:, :, None, :]                       # (B, T, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_chunk(hc, lc, w_unembed):
    """(summed CE over the chunk's valid labels, their count), f32."""
    logits = hc.float() @ w_unembed.float()                  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return torch.stack([torch.sum((lse - gold) * valid), torch.sum(valid)])


def _ce_chunk_split(hc, lc, w_unembed):
    """``_ce_chunk`` with this rank's (D, V / model) block of the
    unembedding: the max and the sum of exponentials over the vocabulary
    by all_reduces over ``model``, the label's logit from the rank that
    holds it (the others add 0)."""
    logits = hc.float() @ w_unembed.float()                  # (B, c, V/m)
    v_loc = logits.shape[-1]
    m = tp.max_over_model(logits.detach().amax(-1))
    lse = m + torch.log(tp.reduce_from_model(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    local = lc.long() - tp.model_index() * v_loc
    mine = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = tp.reduce_from_model(torch.where(mine, gold[..., 0], 0.0))
    valid = (lc >= 0).float()
    return torch.stack([torch.sum((lse - gold) * valid), torch.sum(valid)])


def cross_entropy_chunked(h: torch.Tensor, w_unembed: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 512,
                          vocab_size: int | None = None):
    """Mean CE over tokens with labels >= 0, computed in sequence chunks so
    the (B, T, V) logits tensor is never made whole: each chunk's f32
    logits are recomputed in the backward (``torch.utils.checkpoint``).  A
    ragged T is padded with label -1.  Divides by max(count, 1).

    Under a mesh: ``w_unembed`` may be this rank's block of ``vocab_size``
    columns (the vocab over ``model``; ``h`` then replicated over the
    ``model`` group), and the sum and count are added over the batch axes,
    so every rank returns the mean over the global batch."""
    b, t, _ = h.shape
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    split = vocab_size is not None and w_unembed.shape[1] != vocab_size
    fn = _ce_chunk_split if split else _ce_chunk
    tot = torch.zeros(2, device=h.device)
    for start in range(0, t + pad, c):
        tot = tot + checkpoint(fn, h[:, start:start + c],
                               labels[:, start:start + c], w_unembed,
                               use_reentrant=False, preserve_rng_state=False)
    tot = tp.reduce_over_batch(tot)
    return tot[0] / torch.clamp(tot[1], min=1.0)
