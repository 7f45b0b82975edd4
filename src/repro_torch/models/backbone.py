"""Decoder backbone (counterpart of `repro/models/backbone.py`): init,
the stack applied as a Python loop over periods (each period optionally
recomputed in the backward, as `jax.checkpoint` does in the
reference's scan), the embedding, the LM head and loss, and `forward`.

Layers are grouped into `num_layers // period` periods
(period = len(block_pattern)); remainder layers are the "tail". The
parameter tree keeps the reference's shape and leaf order:
{"embed", "final_ln", "head" (untied only), "stack": {"scan": (one
stacked (n_periods, ...) subtree per period position, or None),
"tail": (unstacked blocks)}}.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.tree import tree_flatten, tree_map


def scan_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(period, n_periods, n_tail)."""
    period = len(cfg.block_pattern)
    n_periods = cfg.num_layers // period
    return period, n_periods, cfg.num_layers - period * n_periods


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _unstack(tree, n: int):
    """n per-layer views of a stacked subtree (None -> n Nones). One
    unbind per leaf, so the backward stacks each leaf's gradient once
    instead of adding n stack-sized gradients of one slice each."""
    if tree is None:
        return [None] * n
    leaves, td = tree_flatten(tree)
    per_leaf = [l.unbind(0) for l in leaves]
    return [td.unflatten([p[i] for p in per_leaf]) for i in range(n)]


def init_stack(gen, cfg: ArchConfig, tp: int, dtype,
               device="cpu") -> Dict[str, Any]:
    period, n_periods, n_tail = scan_layout(cfg)
    pattern = cfg.block_pattern
    scan_params = []
    for pos in range(period):
        layers = [blocks.init_block(gen, pattern[pos], cfg, tp, dtype,
                                    device) for _ in range(n_periods)]
        scan_params.append(_stack(layers) if layers else None)
    tail = tuple(blocks.init_block(gen, pattern[i % period], cfg, tp,
                                   dtype, device) for i in range(n_tail))
    return {"scan": tuple(scan_params), "tail": tail}


def apply_stack(stack_p, x, cfg: ArchConfig, tp: int, *, positions,
                impl="chunked", remat=True):
    """Training/prefill over the whole stack. Returns (x, aux_sum).

    With `remat`, each period runs under torch.utils.checkpoint: its
    activations are recomputed in the backward, as the reference's
    `jax.checkpoint(one_period)` does. Tail layers are not rematted."""
    pattern = cfg.block_pattern
    period = len(pattern)

    def one_period(x, *slices):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(period):
            if slices[pos] is None:
                continue
            x, a = blocks.apply_block(pattern[pos], slices[pos], x, cfg, tp,
                                      positions=positions, impl=impl)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    scan = stack_p["scan"]
    if any(sp is not None for sp in scan):
        n = next(tree_flatten(sp)[0][0].shape[0] for sp in scan
                 if sp is not None)
        per_pos = [_unstack(sp, n) for sp in scan]
        for layer in range(n):
            slices = [per_pos[pos][layer] for pos in range(period)]
            if remat:
                x, a = checkpoint(one_period, x, *slices,
                                  use_reentrant=False)
            else:
                x, a = one_period(x, *slices)
            aux = aux + a
    for i, tp_params in enumerate(stack_p["tail"]):
        x, a = blocks.apply_block(pattern[i % period], tp_params, x, cfg,
                                  tp, positions=positions, impl=impl)
        aux = aux + a
    return x, aux


def padded_vocab(cfg: ArchConfig) -> int:
    """Physical vocab rows padded to a 128 multiple (TP divisibility);
    logits beyond cfg.vocab_size are masked to -inf."""
    return -(-cfg.vocab_size // 128) * 128


def init_params(cfg: ArchConfig, gen, tp: int = 1, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Random init from `gen` (a torch.Generator on `device`; None with
    device="meta" gives shapes and dtypes only)."""
    if tp != 1:
        raise NotImplementedError("vocab padding for tp > 1 is not ported "
                                  "(ROADMAP Queue 1 item 11)")
    if cfg.encoder_layers:
        raise NotImplementedError("encoder stacks are not ported yet "
                                  "(ROADMAP Queue 1 item 10, Whisper)")
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": blocks.init_normal(gen, (v, d), 0.02, dtype, device),
         "final_ln": torch.ones((d,), dtype=dtype, device=device),
         "stack": init_stack(gen, cfg, tp, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = blocks.init_normal(gen, (d, v), 0.02, dtype, device)
    return p


def _embed(params, tokens, cfg: ArchConfig):
    x = params["embed"][tokens]
    if cfg.tie_embeddings:
        # the scale in x's dtype, as jnp's weakly typed Python scalar
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, x, cfg: ArchConfig):
    """(B, S, V) f32: the product in the parameters' dtype, then f32."""
    x = blocks.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = blocks.einsum("bsd,dv->bsv", x, head).float()
    if head.shape[-1] > cfg.vocab_size:     # mask padded vocab rows
        iota = torch.arange(head.shape[-1], device=logits.device)
        logits = torch.where(iota >= cfg.vocab_size,
                             torch.full_like(logits, -1e30), logits)
    return logits


def forward(params, tokens, cfg: ArchConfig, tp: int = 1, mesh=None, *,
            impl="chunked", patches=None, frames=None, remat=True):
    """Training/prefill forward. tokens: (B,S) int.
    patches: (B,P,D) vlm stub embeddings occupying the first P positions.
    Returns (logits, aux_loss)."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported "
                                  "(ROADMAP Queue 1 item 11)")
    if frames is not None or cfg.encoder_layers:
        raise NotImplementedError("encoder stacks are not ported yet "
                                  "(ROADMAP Queue 1 item 10, Whisper)")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, tokens, cfg)
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, P:]], 1)
    x, aux = apply_stack(params["stack"], x, cfg, tp, positions=positions,
                         impl=impl, remat=remat)
    return _logits(params, x, cfg), aux


def lm_loss(logits, tokens, loss_mask=None):
    """Next-token cross entropy. logits: (B,S,V) f32, tokens: (B,S).

    The true-class logit is extracted with an iota-masked reduction, as
    in the reference; its backward is elementwise, so it stays
    deterministic on the card (a gather's backward is a scatter-add)."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, -1)
    iota = torch.arange(lg.shape[-1], device=lg.device)
    true = torch.where(iota == tgt[..., None], lg, 0.0).sum(-1)
    nll = lse - true
    if loss_mask is not None:
        m = loss_mask[:, 1:].float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
