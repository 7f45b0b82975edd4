"""Backbone (counterpart of `repro/models/backbone.py`): init, the
stack applied as a Python loop over periods (each period optionally
recomputed in the backward, as `jax.checkpoint` does in the
reference's scan), the embedding, the LM head and loss, `forward`, and
decoding: `init_cache`, `decode_step` and, for an encoder-decoder model
(Whisper), `setup_cross_cache`.

Layers are grouped into `num_layers // period` periods
(period = len(block_pattern)); remainder layers are the "tail". The
parameter tree keeps the reference's shape and leaf order:
{"embed", "final_ln", "head" (untied only), "stack": {"scan": (one
stacked (n_periods, ...) subtree per period position, or None),
"tail": (unstacked blocks)}}, and for an encoder-decoder model
"enc_stack" (a stack of `enc_attn` blocks, `encoder_layers` deep) and
"enc_final_ln". The decode cache tree is the reference's too: {"scan":
(one stacked (n_periods, ...) cache per period position), "tail":
(unstacked caches)}, each KV cache's `pos` stacked per period.

`param_axes` (and `stack_axes`, `stack_cache_axes`) name every leaf's
logical axes, the reference's trees (the cache's but for the mLSTM's
state, `blocks.block_cache_axes`). Under a mesh, `init_params` keeps
the rank's block of each leaf, and `forward` runs the blocks on them:
the embedding and the head split over `vocab`, the logits the rank's
vocab block, which `lm_loss` reduces with no gather. `init_cache`
allocates only the rank's block of the cache (its rows, kv slots,
lanes or heads), and `decode_step` and `setup_cross_cache` run on it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.shardings import (SCALAR, axis_index, axis_size,
                                          from_model, map_axes,
                                          max_over_model, shard_tree,
                                          sum_over_batch, to_model)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

# the encoder stack's block pattern
ENC_PATTERN = ("enc_attn",)


def scan_layout(cfg: ArchConfig, pattern=None,
                num_layers=None) -> Tuple[int, int, int]:
    """(period, n_periods, n_tail) of the decoder, or of the stack of
    `num_layers` layers of `pattern` (the encoder's)."""
    period = len(pattern or cfg.block_pattern)
    L = cfg.num_layers if num_layers is None else num_layers
    return period, L // period, L % period


def _unstack(tree, n: int):
    """n per-layer views of a stacked subtree (None -> n Nones). One
    unbind per leaf, so the backward stacks each leaf's gradient once
    instead of adding n stack-sized gradients of one slice each."""
    if tree is None:
        return [None] * n
    leaves, td = tree_flatten(tree)
    per_leaf = [l.unbind(0) for l in leaves]
    return [td.unflatten([p[i] for p in per_leaf]) for i in range(n)]


def _stacked_axes(tree):
    def stack_ax(ax):
        if tuple(ax) == SCALAR:
            return (None,)          # stacked scalar -> (n,) vector
        return (None,) + tuple(ax)
    return map_axes(stack_ax, tree)


def init_stack(gen, cfg: ArchConfig, tp: int, dtype, device="cpu",
               pattern=None, num_layers=None, mesh=None) -> Dict[str, Any]:
    """The stack's parameters; under `mesh`, each layer's are cut to the
    rank's blocks as soon as they are drawn. Each layer is written into
    its slice of the stacked buffers as it is drawn, so one layer is the
    transient (a rank of Yi-34B in f32 holds 34 GB of them)."""
    period, n_periods, n_tail = scan_layout(cfg, pattern, num_layers)
    pattern = pattern or cfg.block_pattern

    def block(btype):
        p = blocks.init_block(gen, btype, cfg, tp, dtype, device)
        if mesh is None:
            return p
        return shard_tree(p, blocks.block_axes(btype, cfg), mesh)

    scan_params = []
    for pos in range(period):
        stacked = None
        for i in range(n_periods):
            layer = block(pattern[pos])
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((n_periods,) +
                                                         tuple(t.shape)),
                                   layer)
            tree_map(lambda buf, t: buf[i].copy_(t), stacked, layer)
        scan_params.append(stacked)
    tail = tuple(block(pattern[i % period]) for i in range(n_tail))
    return {"scan": tuple(scan_params), "tail": tail}


def stack_axes(cfg: ArchConfig, pattern=None, num_layers=None):
    period, n_periods, n_tail = scan_layout(cfg, pattern, num_layers)
    pattern = pattern or cfg.block_pattern
    scan_ax = tuple(
        _stacked_axes(blocks.block_axes(pattern[pos], cfg))
        if n_periods else None
        for pos in range(period))
    tail_ax = tuple(blocks.block_axes(pattern[i % period], cfg)
                    for i in range(n_tail))
    return {"scan": scan_ax, "tail": tail_ax}


def _periods(scan) -> int:
    """n_periods of a stacked "scan" tuple (0 when every entry is None)."""
    return next((tree_leaves(sp)[0].shape[0] for sp in scan
                 if sp is not None), 0)


def apply_stack(stack_p, x, cfg: ArchConfig, tp: int, *, positions,
                impl="chunked", pattern=None, enc_out=None,
                enc_positions=None, remat=True, mesh=None):
    """Training/prefill over the whole stack (the decoder's, or that of
    `pattern`). Returns (x, aux_sum). `enc_out` and `enc_positions`, the
    encoder's output and positions, go to every block.

    With `remat`, each period runs under torch.utils.checkpoint: its
    activations are recomputed in the backward, as the reference's
    `jax.checkpoint(one_period)` does. Tail layers are not rematted."""
    pattern = pattern or cfg.block_pattern
    period = len(pattern)
    kw = dict(positions=positions, impl=impl, mesh=mesh)

    def one_period(x, enc_out, enc_positions, *slices):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(period):
            if slices[pos] is None:
                continue
            x, a = blocks.apply_block(pattern[pos], slices[pos], x, cfg, tp,
                                      enc_out=enc_out,
                                      enc_positions=enc_positions, **kw)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    scan = stack_p["scan"]
    n = _periods(scan)
    if n:
        per_pos = [_unstack(sp, n) for sp in scan]
        for layer in range(n):
            slices = [per_pos[pos][layer] for pos in range(period)]
            args = (x, enc_out, enc_positions, *slices)
            if remat:
                x, a = checkpoint(one_period, *args, use_reentrant=False)
            else:
                x, a = one_period(*args)
            aux = aux + a
    for i, tp_params in enumerate(stack_p["tail"]):
        x, a = blocks.apply_block(pattern[i % period], tp_params, x, cfg,
                                  tp, enc_out=enc_out,
                                  enc_positions=enc_positions, **kw)
        aux = aux + a
    return x, aux


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int, tp: int,
                     dtype=torch.bfloat16, device="cpu", mesh=None):
    """The stack's decode caches for `batch` rows: per period position,
    one layer's cache expanded to (n_periods, ...) (one layer's copy is
    the transient); under `mesh` the rank's blocks."""
    period, n_periods, n_tail = scan_layout(cfg)
    pattern = cfg.block_pattern
    one = lambda btype: blocks.init_block_cache(btype, cfg, batch, max_len,
                                                tp, dtype, device, mesh)
    scan = tuple(
        tree_map(lambda t: t.expand(n_periods, *t.shape).contiguous(),
                 one(pattern[pos])) if n_periods else None
        for pos in range(period))
    tail = tuple(one(pattern[i % period]) for i in range(n_tail))
    return {"scan": scan, "tail": tail}


def stack_cache_axes(cfg: ArchConfig, pattern=None, num_layers=None):
    period, n_periods, n_tail = scan_layout(cfg, pattern, num_layers)
    pattern = pattern or cfg.block_pattern
    scan_ax = tuple(
        _stacked_axes(blocks.block_cache_axes(pattern[pos], cfg))
        if n_periods else None
        for pos in range(period))
    tail_ax = tuple(blocks.block_cache_axes(pattern[i % period], cfg)
                    for i in range(n_tail))
    return {"scan": scan_ax, "tail": tail_ax}


def _write_back(cache, new) -> None:
    """Each leaf of `new` that is not already `cache`'s own tensor (a KV
    slot is written in place; pos and the recurrent states are new
    tensors) is copied into it, cast to its dtype."""
    for old, nw in zip(tree_leaves(cache), tree_leaves(new)):
        if nw is not old:
            old.copy_(nw)


def decode_stack(stack_p, stack_c, x, cfg: ArchConfig, tp: int, mesh=None):
    """One decode step over the stack, a Python loop over the periods.

    Each layer decodes against its cache as views of its slice of the
    stacked buffers (or its tail entry), and what it returns is written
    back into them in place: no full-size cache is rebuilt per token.
    Returns (x, stack_c), the cache tree passed in, now one step on.
    Under `mesh`, the rank's blocks of the weights and the cache."""
    pattern = cfg.block_pattern
    period = len(pattern)

    def step(btype, p, x, c):
        x, nc = blocks.decode_block(btype, p, x, c, cfg, tp, mesh)
        _write_back(c, nc)
        return x

    n = _periods(stack_p["scan"])
    if n:
        per_p = [_unstack(sp, n) for sp in stack_p["scan"]]
        per_c = [_unstack(sc, n) for sc in stack_c["scan"]]
        for layer in range(n):
            for pos in range(period):
                if per_p[pos][layer] is not None:
                    x = step(pattern[pos], per_p[pos][layer], x,
                             per_c[pos][layer])
    for i, (tp_params, tc) in enumerate(zip(stack_p["tail"],
                                            stack_c["tail"])):
        x = step(pattern[i % period], tp_params, x, tc)
    return x, stack_c


def padded_vocab(cfg: ArchConfig) -> int:
    """Physical vocab rows padded to a 128 multiple (TP divisibility);
    logits beyond cfg.vocab_size are masked to -inf."""
    return -(-cfg.vocab_size // 128) * 128


def init_params(cfg: ArchConfig, gen, tp: int = 1, dtype=torch.bfloat16,
                device="cpu", mesh=None) -> dict:
    """Random init from `gen` (a torch.Generator on `device`; None with
    device="meta" gives shapes and dtypes only) in the physical layout of
    `tp` (padded heads, and the vocab padded to a multiple of 128 when
    tp > 1). Under `mesh`, only the rank's blocks are kept: each leaf is
    drawn whole, in the one-device order, and cut at once, so every mesh
    of one tp starts from the same model."""
    d = cfg.d_model
    v = padded_vocab(cfg) if tp > 1 else cfg.vocab_size
    p = {"embed": blocks.init_normal(gen, (v, d), 0.02, dtype, device),
         "final_ln": torch.ones((d,), dtype=dtype, device=device)}
    if mesh is not None:
        p = shard_tree(p, {"embed": ("vocab", None), "final_ln": (None,)},
                       mesh)
    p["stack"] = init_stack(gen, cfg, tp, dtype, device, mesh=mesh)
    if not cfg.tie_embeddings:
        p["head"] = blocks.init_normal(gen, (d, v), 0.02, dtype, device)
        if mesh is not None:
            p["head"] = shard_tree(p["head"], (None, "vocab"), mesh)
    if cfg.encoder_layers:
        p["enc_stack"] = init_stack(gen, cfg, tp, dtype, device,
                                    pattern=ENC_PATTERN,
                                    num_layers=cfg.encoder_layers, mesh=mesh)
        p["enc_final_ln"] = torch.ones((d,), dtype=dtype, device=device)
    return p


def param_axes(cfg: ArchConfig) -> dict:
    a = {
        "embed": ("vocab", None),
        "final_ln": (None,),
        "stack": stack_axes(cfg),
    }
    if not cfg.tie_embeddings:
        a["head"] = (None, "vocab")
    if cfg.encoder_layers:
        a["enc_stack"] = stack_axes(cfg, pattern=ENC_PATTERN,
                                    num_layers=cfg.encoder_layers)
        a["enc_final_ln"] = (None,)
    return a


def check_mesh(cfg: ArchConfig, tp: int, mesh) -> None:
    """Raises ValueError unless every block of `cfg` splits over the
    mesh's `model` extent and `tp` is that extent (nothing without a
    mesh)."""
    if mesh is None:
        return
    for btype in set(cfg.block_pattern) | (
            set(ENC_PATTERN) if cfg.encoder_layers else set()):
        blocks.check_split(btype, cfg, axis_size(mesh, "heads"))
    if tp != axis_size(mesh, "heads"):
        raise ValueError(f"tp {tp} is not the mesh's model extent "
                         f"{axis_size(mesh, 'heads')}")


def encode(params, frames, cfg: ArchConfig, tp: int = 1, *,
           impl="chunked", remat=True, mesh=None):
    """The encoder over frames (B, F, D): the `enc_attn` stack, then
    RMSNorm. It runs in the dtype `frames` and the weights promote to
    (f32 frames beside bf16 weights run it in f32), as in the
    reference. Under `mesh`, the rank's rows of frames."""
    B, F = frames.shape[:2]
    enc_pos = torch.arange(F, device=frames.device)[None].expand(B, F)
    e, _ = apply_stack(params["enc_stack"], frames, cfg, tp,
                       positions=enc_pos, impl=impl, pattern=ENC_PATTERN,
                       remat=remat, mesh=mesh)
    return blocks.rmsnorm(e, params["enc_final_ln"], cfg.norm_eps), enc_pos


def _embed(params, tokens, cfg: ArchConfig, mesh=None):
    """Token embeddings; under a mesh each rank looks up the tokens in
    its vocab block (zero elsewhere) and the blocks are added up. The
    lookup is `embedding`'s, whose backward sums a row's gradients in
    f32 before it rounds them to the table's dtype; an indexing backward
    adds them one at a time in that dtype, and in bf16 a frequent
    token's sum then loses its small terms (the more, the more rows one
    rank sums)."""
    emb = params["embed"]
    lookup = torch.nn.functional.embedding
    if mesh is None:
        x = lookup(tokens, emb)
    else:
        idx = tokens - axis_index(mesh, "vocab") * emb.shape[0]
        hit = (idx >= 0) & (idx < emb.shape[0])
        x = from_model(lookup(torch.where(hit, idx, 0), emb) *
                       hit[..., None].to(emb.dtype), mesh)
    if cfg.tie_embeddings:
        # the scale in x's dtype, as jnp's weakly typed Python scalar;
        # filled on the device (a copy from the host would sync a decode)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _logits(params, x, cfg: ArchConfig, mesh=None):
    """(B, S, V) f32: the product in the parameters' dtype, then f32;
    under a mesh, V is the rank's vocab block."""
    x = blocks.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = blocks.einsum("bsd,dv->bsv", to_model(x, mesh), head).float()
    v = head.shape[-1]
    if v * axis_size(mesh, "vocab") > cfg.vocab_size:   # mask padded rows
        iota = torch.arange(v, device=logits.device) + \
            axis_index(mesh, "vocab") * v
        logits = torch.where(iota >= cfg.vocab_size,
                             torch.full_like(logits, -1e30), logits)
    return logits


def forward(params, tokens, cfg: ArchConfig, tp: int = 1, mesh=None, *,
            impl="chunked", patches=None, frames=None, remat=True):
    """Training/prefill forward. tokens: (B,S) int.
    patches: (B,P,D) vlm stub embeddings occupying the first P positions.
    frames: (B,F,D) the encoder's frame embeddings (Whisper's stub).
    Under `mesh`, params hold the rank's blocks (`init_params(...,
    mesh=mesh)`), tokens, patches and frames its rows, and the logits
    are its vocab block.
    Returns (logits, aux_loss)."""
    check_mesh(cfg, tp, mesh)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, tokens, cfg, mesh)
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, P:]], 1)
    enc_out = enc_pos = None
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} has an encoder: pass its frames")
        enc_out, enc_pos = encode(params, frames, cfg, tp, impl=impl,
                                  remat=remat, mesh=mesh)
        # every decoder layer's cross K/V projects it to the rank's kv
        # slots: its gradient is summed over `model` once, here
        enc_out = to_model(enc_out, mesh)
    x, aux = apply_stack(params["stack"], x, cfg, tp, positions=positions,
                         impl=impl, enc_out=enc_out, enc_positions=enc_pos,
                         remat=remat, mesh=mesh)
    return _logits(params, x, cfg, mesh), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, tp: int = 1,
               dtype=torch.bfloat16, device=None, mesh=None):
    """The decode cache for `batch` sequences of up to `max_len` tokens
    (a ring of `attention_window` slots for local attention), on
    `device` (the card unless the caller names another). An
    encoder-decoder model's cross K/V are zeros until
    `setup_cross_cache` fills them. Under `mesh`, `batch` is the global
    batch, which must split evenly over the data ranks, and only the
    rank's block is allocated (`stack_cache_axes`): its rows, and its kv
    slots, lanes or heads of each layer's."""
    check_mesh(cfg, tp, mesh)
    dp = axis_size(mesh, "batch")
    if batch % dp:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"{dp} data rank(s)")
    return init_stack_cache(cfg, batch // dp, max_len, tp, dtype,
                            resolve_device(device, "init_cache"), mesh)


def decode_step(params, cache, tokens, cfg: ArchConfig, tp: int = 1,
                mesh=None):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1, V)
    f32, cache); the cache passed in is updated in place and returned.
    Under `mesh`, params and the cache hold the rank's blocks
    (`init_params` and `init_cache` with the mesh), tokens its rows,
    and the logits are its vocab block, as `forward` gives them."""
    check_mesh(cfg, tp, mesh)
    x = _embed(params, tokens, cfg, mesh)
    x, cache = decode_stack(params["stack"], cache, x, cfg, tp, mesh)
    return _logits(params, x, cfg, mesh), cache


@torch.no_grad()
def setup_cross_cache(params, cache, frames, cfg: ArchConfig, tp: int = 1,
                      mesh=None, impl="chunked"):
    """Whisper: run the encoder once over frames (B, F, D), without
    remat, and write each decoder layer's cross K/V into the cache in
    place, one layer at a time into its slice of the stacked buffers
    (cast to their dtype), as `decode_stack` writes back. Returns the
    cache passed in. Under `mesh`, frames are the rank's rows and each
    layer's cross K/V its kv slots, projected from the encoder's output
    once it has entered the tensor-parallel region."""
    check_mesh(cfg, tp, mesh)
    enc_out, _ = encode(params, frames, cfg, tp, impl=impl, remat=False,
                        mesh=mesh)
    enc_out = to_model(enc_out, mesh)

    def fill(p, c):
        for buf, t in zip((c["cross_k"], c["cross_v"]),
                          blocks.cross_kv(p["xattn"], enc_out)):
            buf.copy_(t)

    stack_p = params["stack"]
    n = _periods(stack_p["scan"])
    for sp, sc in zip(stack_p["scan"], cache["scan"]):
        if sp is not None and "cross_k" in sc:
            for p, c in zip(_unstack(sp, n), _unstack(sc, n)):
                fill(p, c)
    for p, c in zip(stack_p["tail"], cache["tail"]):
        if "cross_k" in c:
            fill(p, c)
    return cache


def lm_loss(logits, tokens, loss_mask=None, mesh=None):
    """Next-token cross entropy. logits: (B,S,V) f32, tokens: (B,S).

    The true-class logit is extracted with an iota-masked reduction, as
    in the reference; its backward is elementwise, so it stays
    deterministic on the card (a gather's backward is a scatter-add).
    Under a mesh, logits are the rank's vocab block of its rows: the
    log-sum-exp and the true logit are summed over `model`, and the
    result is the rank's share of the mean over the global batch (the
    data ranks' shares add up to it, also where masks make their counts
    differ)."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, -1)
    if mesh is not None:
        top = max_over_model(lse, mesh)
        lse = top + torch.log(from_model(torch.exp(lse - top), mesh))
    iota = torch.arange(lg.shape[-1], device=lg.device) + \
        axis_index(mesh, "vocab") * lg.shape[-1]
    true = from_model(torch.where(iota == tgt[..., None], lg, 0.0).sum(-1),
                      mesh)
    nll = lse - true
    if loss_mask is not None:
        m = loss_mask[:, 1:].float()
        count = sum_over_batch(m.sum(), mesh)
        return (nll * m).sum() / torch.clamp(count, min=1.0)
    if mesh is None:
        return nll.mean()
    return nll.mean() / axis_size(mesh, "batch")
