"""Decoder backbone (counterpart of `repro/models/backbone.py`) for
period-1 `attn` stacks: init, the stack applied as a Python loop over
the stacked layer dim, and the LM loss.

The parameter tree keeps the reference's shape and leaf order:
{"embed", "final_ln", "head", "stack": {"scan": ({stacked (L, ...)
leaves},), "tail": ()}}.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.tree import tree_map


def scan_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(period, n_periods, n_tail)."""
    period = len(cfg.block_pattern)
    n_periods = cfg.num_layers // period
    return period, n_periods, cfg.num_layers - period * n_periods


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
                impl="chunked"):
    """Training/prefill over the whole stack. Returns (x, aux_sum)."""
    pattern = cfg.block_pattern
    period = len(pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    scan = stack_p["scan"]
    if any(sp is not None for sp in scan):
        n = next(sp for sp in scan if sp is not None)["ln1"].shape[0]
        for layer in range(n):
            for pos in range(period):
                if scan[pos] is None:
                    continue
                p = tree_map(lambda t: t[layer], scan[pos])
                x, a = blocks.apply_block(pattern[pos], p, x, cfg, tp,
                                          positions=positions, impl=impl)
                aux = aux + a
    for i, tp_params in enumerate(stack_p["tail"]):
        x, a = blocks.apply_block(pattern[i % period], tp_params, x, cfg,
                                  tp, positions=positions, impl=impl)
        aux = aux + a
    return x, aux


def init_params(cfg: ArchConfig, gen, tp: int = 1, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Random init from `gen` (a torch.Generator on `device`; None with
    device="meta" gives shapes and dtypes only)."""
    if tp != 1:
        raise NotImplementedError("vocab padding for tp > 1 is not ported")
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": blocks.init_normal(gen, (v, d), 0.02, dtype, device),
         "final_ln": torch.ones((d,), dtype=dtype, device=device),
         "stack": init_stack(gen, cfg, tp, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = blocks.init_normal(gen, (d, v), 0.02, dtype, device)
    if cfg.encoder_layers:
        raise NotImplementedError("encoder stacks are not ported")
    return p


def lm_loss(logits, tokens):
    """Next-token cross entropy. logits: (B,S,V) f32, tokens: (B,S).

    The true-class logit is extracted with an iota-masked reduction, as
    in the reference; its backward is elementwise, so it stays
    deterministic on the card (a gather's backward is a scatter-add)."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, -1)
    iota = torch.arange(lg.shape[-1], device=lg.device)
    true = torch.where(iota == tgt[..., None], lg, 0.0).sum(-1)
    return (lse - true).mean()
