"""LXMERT cross-modal encoder (counterpart of `xggm_tpu/models/lxmert.py`).

The parameter tree is the JAX package's: one fused `qkv` projection per
self-attention, `query` plus a fused `kv` for cross-attention, and the
x-layer's cross-attention weights shared in both directions. Submodules carry
the flax names, with the per-layer lists as `encoder.layer`, `.r_layers` and
`.x_layers`, so `checkpoint.jax_params.from_jax_params` maps a JAX tree onto
`state_dict()` key by key.

Parameters are float32; matmul inputs are cast to the compute dtype
(bfloat16 on the card); LayerNorm and softmax run in float32.

Every forward takes an optional `rng` (`ops.basic.DropoutRng`). Without one
it is the JAX package's `deterministic=True` forward, and every attention
goes through `ops.attention.mha` (kernel 1). With one it is the training
forward: hidden dropout at the JAX package's four sites (embeddings,
AttOutput, Mlp, VisualFeatEncoder) draws from the rng's device generator,
and every attention goes through `ops.attention.mha_dropout` (kernels 2 and
3) with a fresh 31-bit seed per call, as the JAX package draws one per call.
At probability 0 the dropout is skipped and attention takes `mha`.

With `LxmertConfig.remat` each language, relational and cross layer runs
under `torch.utils.checkpoint` (non-reentrant), as the JAX package wraps
`BertLayer` and `XLayer` in `nn.remat`: the backward recomputes the layer's
activations from its inputs. The recompute must draw the forward's masks
and kernel seeds again, and `checkpoint` restores only the global RNGs, not
a `DropoutRng`'s explicit generators: `_remat` saves their state at the
layer's start and puts it back before the recompute (the attention kernels
redraw their masks from the same seeds).

With `LxmertConfig.stacked_layers` the encoder holds three `LayerStack`s,
`lang_stack`, `r_stack` and `x_stack`, each a `layer` of BertLayer or
XLayer shape whose every parameter has a leading [L] dim, the JAX package's
`nn.scan` layout: layer i runs the template on the i-th slice of each
(`torch.func.functional_call`), and its output is that of the per-layer
encoder with the same weights. Indexing a stacked parameter per layer
accumulates the L slice-gradients into one [L, ...] gradient. With
`pp_stages` > 1 too, the stacks run as a GPipe pipeline over the pipe group
(`parallel/pipeline_lxmert.py`): the embeddings and `visn_fc` run on stage 0
alone, and every stage but the last raises `NotLastStage` once its share of
the forward has run.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from xggm_tpu_torch.config import BertConfig, LxmertConfig
from xggm_tpu_torch.ops.attention import mha, mha_dropout
from xggm_tpu_torch.ops.basic import (
    Dense, DropoutRng, Embedding, LayerNorm, gelu, maybe_dropout)
from xggm_tpu_torch.parallel.pipeline_lxmert import (
    pipeline_mesh, pipelined_lxr_stack)
from xggm_tpu_torch.utils.device import resolve_device

NEG_INF_MASK = -10000.0


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} -> [B, L] float32 additive key bias in {0, -10000}
    (the JAX version's [B, 1, 1, L] without the broadcast axes)."""
    return (1.0 - mask.float()) * NEG_INF_MASK


def _dense(c: BertConfig, n_in: int, n_out: int, dtype, device) -> Dense:
    return Dense(n_in, n_out, dtype, stddev=c.initializer_range, device=device)


def _lookup(table: Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows for `ids`, with the gradient of every position whose
    id is 0 dropped (torch's padding_idx=0, as the JAX package's `lookup`):
    the padding row, and the [CLS] position's row, do not train."""
    out = table(ids)
    if not out.requires_grad:
        return out
    return torch.where((ids != 0)[..., None], out, out.detach())


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, then LayerNorm."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.p = c.hidden_dropout_prob
        kw = dict(stddev=c.initializer_range, device=device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                   device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (_lookup(self.word_embeddings, input_ids)
             + _lookup(self.position_embeddings, pos.expand_as(input_ids))
             + _lookup(self.token_type_embeddings, token_type_ids))
        x = maybe_dropout(self.LayerNorm(x), self.p, rng)
        return x.to(self.dtype)


class Attention(nn.Module):
    """Multi-head attention core. Self-attention fuses Q, K, V into `qkv`;
    cross-attention has `query` and a fused `kv` over the context."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, cross: bool,
                 device=None):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_attention_heads
        self.dtype = dtype
        self.cross = cross
        self.p = c.attention_probs_dropout_prob
        if cross:
            self.query = _dense(c, h, h, dtype, device)
            self.kv = _dense(c, h, 2 * h, dtype, device)
        else:
            self.qkv = _dense(c, h, 3 * h, dtype, device)

    def forward(self, hidden: torch.Tensor, context: torch.Tensor,
                bias: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        b, lq, width = hidden.shape
        lk = context.shape[1]
        if self.cross:
            q = self.query(hidden)
            k, v = self.kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(hidden).chunk(3, dim=-1)

        def heads_first(x, length):
            return x.view(b, length, self.heads, -1).transpose(1, 2)

        q, k, v = heads_first(q, lq), heads_first(k, lk), heads_first(v, lk)
        if rng is None or self.p == 0.0:
            ctx = mha(q, k, v, bias)
        else:
            ctx = mha_dropout(q, k, v, bias, rng.seed31(), self.p)
        return ctx.transpose(1, 2).reshape(b, lq, width).to(self.dtype)


class AttOutput(nn.Module):
    """Projection + residual LayerNorm."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.dense = _dense(c, c.hidden_size, c.hidden_size, dtype, device)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                   device=device)
        self.p = c.hidden_dropout_prob

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = maybe_dropout(self.dense(hidden), self.p, rng)
        return self.LayerNorm(x + residual)


class SelfAttLayer(nn.Module):
    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.self = Attention(c, dtype, cross=False, device=device)
        self.output = AttOutput(c, dtype, device=device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.output(self.self(x, x, bias, rng), x, rng)


class CrossAttLayer(nn.Module):
    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.att = Attention(c, dtype, cross=True, device=device)
        self.output = AttOutput(c, dtype, device=device)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                ctx_bias: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.output(self.att(x, ctx, ctx_bias, rng), x, rng)


class Mlp(nn.Module):
    """Intermediate + output FFN with residual LayerNorm."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.intermediate = _dense(c, c.hidden_size, c.intermediate_size,
                                   dtype, device)
        self.output = _dense(c, c.intermediate_size, c.hidden_size, dtype,
                             device)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                   device=device)
        self.p = c.hidden_dropout_prob

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        h = maybe_dropout(self.output(gelu(self.intermediate(x))), self.p,
                          rng)
        return self.LayerNorm(x + h)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.attention = SelfAttLayer(c, dtype, device=device)
        self.mlp = Mlp(c, dtype, device=device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.mlp(self.attention(x, bias, rng), rng)


class XLayer(nn.Module):
    """Cross-modality layer. One cross-attention block serves both
    directions, and both read the layer's inputs before either update."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.visual_attention = CrossAttLayer(c, dtype, device=device)
        self.lang_self_att = SelfAttLayer(c, dtype, device=device)
        self.visn_self_att = SelfAttLayer(c, dtype, device=device)
        self.lang_mlp = Mlp(c, dtype, device=device)
        self.visn_mlp = Mlp(c, dtype, device=device)

    def forward(self, lang: torch.Tensor, lang_bias: Optional[torch.Tensor],
                visn: torch.Tensor, visn_bias: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        lang_x = self.visual_attention(lang, visn, visn_bias, rng)
        visn_x = self.visual_attention(visn, lang, lang_bias, rng)
        lang_x = self.lang_self_att(lang_x, lang_bias, rng)
        visn_x = self.visn_self_att(visn_x, visn_bias, rng)
        return self.lang_mlp(lang_x, rng), self.visn_mlp(visn_x, rng)


class VisualFeatEncoder(nn.Module):
    """(LN(W_f feats) + LN(W_b boxes)) / 2."""

    def __init__(self, cfg: LxmertConfig, *, device=None):
        super().__init__()
        c, v, dt = cfg.bert, cfg.visual, cfg.compute_dtype
        self.dtype = dt
        self.visn_fc = _dense(c, v.visual_feat_dim, c.hidden_size, dt, device)
        self.visn_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                         device=device)
        self.box_fc = _dense(c, v.visual_pos_dim, c.hidden_size, dt, device)
        self.box_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                        device=device)
        self.p = c.hidden_dropout_prob

    def forward(self, feats: torch.Tensor, boxes: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = self.visn_layer_norm(self.visn_fc(feats.to(self.dtype)))
        y = self.box_layer_norm(self.box_fc(boxes.to(self.dtype)))
        return maybe_dropout((x + y) * 0.5, self.p, rng)


class Pooler(nn.Module):
    """tanh(dense(hidden[:, 0]))."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.dense = _dense(c, c.hidden_size, c.hidden_size, dtype, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


def _remat(layer: Callable, rng: Optional[DropoutRng], *args):
    """`layer(*args, rng)`, its activations recomputed in the backward; the
    recompute replays `rng`'s draws from the state it had here."""
    if not torch.is_grad_enabled():
        return layer(*args, rng)
    if rng is None:
        return checkpoint(layer, *args, None, use_reentrant=False,
                          preserve_rng_state=False)
    start = rng.get_state()

    def run(*inputs):
        rng.set_state(start)
        return layer(*inputs, rng)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class LayerStack(nn.Module):
    """`length` layers of one shape with stacked parameters: `layer` is a
    template whose every parameter has a leading [length] dim (the JAX
    package's `nn.scan` layout); layer i is the template run on the i-th
    slice of each."""

    def __init__(self, template: nn.Module, length: int, *, device=None):
        super().__init__()
        self.length = length
        for mod in template.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(
                    torch.empty((length, *p.shape), device=device)))
        self.layer = template

    def layer_fn(self, i: int) -> Callable:
        """Layer i as a function of the template's forward arguments."""
        def run(*args):
            params = {n: p[i] for n, p in self.layer.named_parameters()}
            return torch.func.functional_call(self.layer, params, args)
        return run


class LxmertEncoder(nn.Module):
    """Visual embedding -> language layers -> relational (visual) layers ->
    cross-modality layers; each layer rematerialised with `cfg.remat`,
    stacked with `cfg.stacked_layers`, pipelined with `cfg.pp_stages`."""

    def __init__(self, cfg: LxmertConfig, *, device=None):
        super().__init__()
        if cfg.pp_stages > 1 and not cfg.stacked_layers:
            raise ValueError("pp_stages > 1 requires stacked_layers=True "
                             "(the [L, ...] layout the pipeline's stages "
                             "are cut from)")
        self.remat = cfg.remat
        self.pp_stages = cfg.pp_stages
        c, v, dt = cfg.bert, cfg.visual, cfg.compute_dtype
        self.hidden_size, self.dtype = c.hidden_size, dt
        self.visn_fc = VisualFeatEncoder(cfg, device=device)
        self.stacked = cfg.stacked_layers
        if self.stacked:
            self.lang_stack = LayerStack(BertLayer(c, dt, device="meta"),
                                         v.l_layers, device=device)
            self.r_stack = LayerStack(BertLayer(c, dt, device="meta"),
                                      v.r_layers, device=device)
            self.x_stack = LayerStack(XLayer(c, dt, device="meta"),
                                      v.x_layers, device=device)
            return
        self.layer = nn.ModuleList(
            BertLayer(c, dt, device=device) for _ in range(v.l_layers))
        self.r_layers = nn.ModuleList(
            BertLayer(c, dt, device=device) for _ in range(v.r_layers))
        self.x_layers = nn.ModuleList(
            XLayer(c, dt, device=device) for _ in range(v.x_layers))

    def runs_inputs(self) -> bool:
        """Whether this rank embeds the inputs: always, but under
        `pp_stages` > 1 on pipeline stage 0 alone."""
        if self.pp_stages <= 1:
            return True
        mesh = pipeline_mesh()
        return mesh is None or mesh.pipe_rank == 0

    def _layers(self):
        """(language, relational, cross) layers as functions of the
        layers' forward arguments."""
        if self.stacked:
            return tuple([s.layer_fn(i) for i in range(s.length)]
                         for s in (self.lang_stack, self.r_stack,
                                   self.x_stack))
        return self.layer, self.r_layers, self.x_layers

    def forward(self, lang: Optional[torch.Tensor],
                lang_bias: Optional[torch.Tensor],
                feats: torch.Tensor, boxes: torch.Tensor,
                visn_bias: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lang, visn) outputs. Under `pp_stages` > 1 `lang` is None on
        every stage but the first, and every stage but the last raises
        `NotLastStage`."""
        if self.pp_stages > 1:
            first = self.runs_inputs()
            visn = self.visn_fc(feats, boxes, rng) if first else None
            return pipelined_lxr_stack(self, lang, visn, lang_bias,
                                       visn_bias, rng,
                                       visn_len=feats.shape[1])
        visn = self.visn_fc(feats, boxes, rng)

        def run(layer, *args):
            if self.remat:
                return _remat(layer, rng, *args)
            return layer(*args, rng)

        lang_layers, r_layers, x_layers = self._layers()
        for layer in lang_layers:
            lang = run(layer, lang, lang_bias)
        for layer in r_layers:
            visn = run(layer, visn, visn_bias)
        for layer in x_layers:
            lang, visn = run(layer, lang, lang_bias, visn, visn_bias)
        return lang, visn


class LxmertModel(nn.Module):
    """Embeddings + encoder + pooler. Returns ((lang_seq, visn_seq), pooled).

    Parameters are created uninitialised on `device`; draw them with
    `ops.basic.init_weights(model, generator)` or load a state dict."""

    def __init__(self, cfg: LxmertConfig, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        dt = cfg.compute_dtype
        self.embeddings = BertEmbeddings(cfg.bert, dt, device=dev)
        self.encoder = LxmertEncoder(cfg, device=dev)
        self.pooler = Pooler(cfg.bert, dt, device=dev)

    def forward(self, input_ids: torch.Tensor,
                input_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                feats: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                visn_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None):
        if input_mask is None:
            input_mask = torch.ones_like(input_ids)
        lang_bias = additive_mask(input_mask)
        visn_bias = None if visn_mask is None else additive_mask(visn_mask)
        emb = (self.embeddings(input_ids, token_type_ids, rng)
               if self.encoder.runs_inputs() else None)
        lang, visn = self.encoder(emb, lang_bias, feats, boxes, visn_bias,
                                  rng)
        return (lang, visn), self.pooler(lang)


class BertTextModel(nn.Module):
    """Text-only BERT: embeddings, `num_layers` BertLayers (`layer.i`) and
    the pooler, in `dtype` (float32 by default, as the JAX package's).
    Returns (sequence [B, L, H], pooled [B, H]); its attention is kernel 1
    on the card (kernels 2 and 3 with an rng and a dropout rate above 0).
    The adjacency precompute (`tools/compute_adjacency.py`) embeds object
    and attribute names with its pooled output.

    Parameters are created uninitialised on `device`; draw them with
    `ops.basic.init_weights(model, generator)` or load a state dict."""

    def __init__(self, c: BertConfig, num_layers: int = 12,
                 dtype: torch.dtype = torch.float32, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.embeddings = BertEmbeddings(c, dtype, device=dev)
        self.layer = nn.ModuleList(BertLayer(c, dtype, device=dev)
                                   for _ in range(num_layers))
        self.pooler = Pooler(c, dtype, device=dev)

    def forward(self, input_ids: torch.Tensor,
                input_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if input_mask is None:
            input_mask = torch.ones_like(input_ids)
        bias = additive_mask(input_mask)
        x = self.embeddings(input_ids, token_type_ids, rng)
        for layer in self.layer:
            x = layer(x, bias, rng)
        return x, self.pooler(x)


class AnswerHead(nn.Module):
    """hid -> 2 hid -> GeLU -> LN(1e-12) -> num_answers, float32 logits."""

    def __init__(self, hidden_size: int, num_answers: int,
                 dtype: torch.dtype, *, device=None):
        super().__init__()
        self.fc1 = Dense(hidden_size, 2 * hidden_size, dtype, device=device)
        self.ln = LayerNorm(2 * hidden_size, device=device)
        self.fc2 = Dense(2 * hidden_size, num_answers, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.ln(gelu(self.fc1(x)))).float()


class PredictionHeadTransform(nn.Module):
    """dense -> GeLU -> LayerNorm(layer_norm_eps), the shared front of the
    pretraining heads."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.dense = _dense(c, c.hidden_size, c.hidden_size, dtype, device)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(gelu(self.dense(x)))


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [..., D] against every row of `table` [V, D]: float32 logits
    [..., V] from operands rounded to x's dtype, as the JAX package's einsum
    with preferred_element_type=float32. The rounded operands are multiplied
    in float32, so the products are exact and the sums float32."""
    t = table.to(x.dtype)
    if x.dtype != torch.float32:
        x, t = x.float(), t.float()
    return torch.matmul(x, t.t())


class LMPredictionHead(nn.Module):
    """Masked-LM head: transform, then the decoder tied to the encoder's
    word-embedding table (passed at call time; its gradient from here
    reaches every row, row 0 included), plus `bias` [vocab]."""

    def __init__(self, c: BertConfig, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.transform = PredictionHeadTransform(c, dtype, device=device)
        self.bias = nn.Parameter(torch.empty(c.vocab_size, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                word_embedding: torch.Tensor) -> torch.Tensor:
        return tied_logits(self.transform(x), word_embedding) + self.bias


class VisualObjHead(nn.Module):
    """One decoder per visual loss (`decoder_obj`, `decoder_attr`,
    `decoder_feat`) over a shared transform; float32 outputs by loss
    name."""

    def __init__(self, c: BertConfig, visual_losses: Sequence[str],
                 loss_dims: Sequence[int], dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.visual_losses = tuple(visual_losses)
        self.transform = PredictionHeadTransform(c, dtype, device=device)
        for key, dim in zip(self.visual_losses, loss_dims):
            setattr(self, f"decoder_{key}",
                    Dense(c.hidden_size, dim, dtype, device=device))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.transform(x)
        return {key: getattr(self, f"decoder_{key}")(x).float()
                for key in self.visual_losses}
