"""Model composition for all ten configurations: the dense, MoE
(DeepSeek-V2's MLA among them), RWKV-6 (``ssm``), hybrid (Jamba's Mamba
layers with one attention layer a period), encoder-decoder (Whisper) and
VLM (PaliGemma's image-patch prefix) families.

The reference (``repro.models.lm``) keeps the dense prefix layers apart,
stacks the parameters of all periods (and of the encoder's layers) on a
leading axis and applies them with ``jax.lax.scan``; PyTorch runs eagerly,
so ``LM`` holds one entry per layer in ``blocks``, the dense prefix first
(and in ``encoder``), and ``backbone`` is a Python loop over them.
``params_from_reference`` carries the reference's parameters across (numpy
in, the prefix first, the period and encoder axes unstacked), so both
packages compute the same thing in the tests.

Entry points (the reference's ``prefill_fn``, ``decode_fn`` and
``loss_fn``):
  * forward(cfg, model, batch)             -- full-sequence logits; batch
    holds ``tokens``, and ``frames`` (encdec) or ``patches`` (vlm)
  * loss_fn(cfg, model, batch)             -- the masked mean of
    ``-log_softmax`` at ``labels``, for training
  * decode_step(cfg, model, cache, batch)  -- one token against the caches;
    an encdec batch holds ``frames``, encoded again at every step as the
    reference does
  * DecodeGraph(cfg, model, cache, extra)  -- the decode step captured once
    as a CUDA graph, replayed per token: the counterpart of the
    reference's ``@jax.jit`` decode (``repro.launch.serve``)

Training: the parameters are created frozen, as serving wants them;
``model.requires_grad_(True)`` makes them trainable, and ``param_list``
gives them in the fixed order the optimiser and checkpoints use.  With
grad enabled, ``cfg.remat`` is honoured as the reference's ``_remat``:
"full" recomputes each layer in the backward (``torch.utils.checkpoint``,
non-reentrant; the layer's K4 forward then runs twice a step), "dots"
saves the layers' plain matrix products and recomputes the rest, "none"
keeps everything.  K4 and K5 (RWKV) are differentiable on the card
through their backward kernels (``flash_attention._Attention``,
``wkv6._WKV``).

A sharded step (``launch.steps``) builds the model over the rank's shards
and installs its all-gather (``gathering``): each layer's weights are
gathered at the layer's entry, inside the function ``_remat`` checkpoints
(so the backward's recompute gathers them again, as the reference's scan
body under ``jax.checkpoint`` does), and the embedding, the head, the
final norm and the encoder's and image projection's tensors where they
are used.  With none installed a weight is used as it is.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import ArchConfig
from repro_torch.kernels import flash_attention, wkv6
from repro_torch.models import layers as L
from repro_torch.parallel import tensor_parallel as tp

# ---------------------------------------------------------------------------
# per-position layer spec within a period
# ---------------------------------------------------------------------------


def period_specs(cfg: ArchConfig) -> list[tuple[str, str]]:
    """[(mix_kind, ffn_kind)] for each position in a period (after the dense
    prefix).  mix: attn|mla|mamba|rwkv.  ffn: mlp|moe|rwkv (fused)."""
    specs = []
    base = cfg.dense_prefix_layers
    for pos in range(cfg.period):
        li = base + pos
        mix = cfg.layer_kind(li)
        if mix == "rwkv":
            ffn = "rwkv"
        elif cfg.is_moe_layer(li):
            ffn = "moe"
        else:
            ffn = "mlp"
        specs.append((mix, ffn))
    return specs


def n_periods(cfg: ArchConfig) -> int:
    body = cfg.n_layers - cfg.dense_prefix_layers
    assert body % cfg.period == 0, (cfg.name, body, cfg.period)
    return body // cfg.period


def layer_specs(cfg: ArchConfig) -> list[tuple[str, str]]:
    """The (mix, ffn) spec of every layer, in order: the dense prefix
    layers (an MLP at the dense ``d_ff``), then the periods."""
    prefix = [(cfg.layer_kind(i), "mlp")
              for i in range(cfg.dense_prefix_layers)]
    return prefix + period_specs(cfg) * n_periods(cfg)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device``.  The reference draws from ``jax.random``; the two
    give different numbers from one seed.  On the ``meta`` device nothing
    is drawn (``generator`` may be None): the parameters' shapes and dtypes
    alone (``launch.steps.abstract_params``)."""
    dev = torch.device(device)
    dt = L._dt(cfg)
    D, V = cfg.d_model, cfg.vocab
    params = {"embed": L._normal(generator, (V, D), 0.02, dt, dev),
              "final_norm": torch.ones((D,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(generator, (D, V), D ** -0.5, dt, dev)
    init_mix = {"attn": L.init_attn, "mla": L.init_mla,
                "mamba": L.init_mamba, "rwkv": L.init_rwkv}
    blocks = []
    for mix, ffn in layer_specs(cfg):
        layer = {"mix": init_mix[mix](cfg, generator, dev)}
        if ffn != "rwkv":
            init_ffn = L.init_moe if ffn == "moe" else L.init_mlp
            layer["ffn"] = init_ffn(cfg, generator, dev)
        if cfg.family == "encdec":
            layer["cross"] = L.init_cross_attn(cfg, generator, dev)
        blocks.append(layer)
    params["blocks"] = blocks
    if cfg.family == "encdec":
        params["encoder"] = [{"mix": L.init_attn(cfg, generator, dev),
                              "ffn": L.init_mlp(cfg, generator, dev)}
                             for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = torch.ones((D,), dtype=dt, device=dev)
    if cfg.family == "vlm":
        params["img_proj"] = L._normal(generator, (D, D), D ** -0.5, dt, dev)
    return params


def params_from_reference(cfg: ArchConfig, tree: dict,
                          device="cuda") -> dict:
    """The port's parameters from ``repro.models.lm.init_params``' pytree
    given as numpy arrays (``jax.tree.map(np.asarray, params)``): the
    ``prefix`` layers come first, the leading period axis of ``blocks`` is
    unstacked into one entry per layer, as is the ``encoder``'s leading
    layer axis, nested dicts (the MoE's ``shared`` MLP) stay nested, and
    every array is copied to ``device`` in its own dtype."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: via f32
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)   # a writable copy

    def layer(sub, i=None):
        """A layer's (nested) dict; ``i`` picks a period of a stack."""
        if isinstance(sub, dict):
            return {k: layer(a, i) for k, a in sub.items()}
        return conv(sub if i is None else np.asarray(sub)[i])

    params = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head",
                                         "enc_norm", "img_proj")
              if k in tree}
    blocks = [layer(tree["prefix"][j])
              for j in range(cfg.dense_prefix_layers)]
    for i in range(n_periods(cfg)):
        for pos in range(cfg.period):
            blocks.append(layer(tree["blocks"][f"pos{pos}"], i))
    params["blocks"] = blocks
    if "encoder" in tree:
        params["encoder"] = [layer(tree["encoder"], i)
                             for i in range(cfg.n_enc_layers)]
    return params


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _param_dict(tree: dict) -> nn.ParameterDict:
    """A ``ParameterDict`` of frozen parameters; a nested dict (the MoE's
    ``shared`` MLP) becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({k: _param_dict(t) if isinstance(t, dict)
                             else _frozen(t) for k, t in tree.items()})


def _layers(layers: list) -> nn.ModuleList:
    """One ``ModuleDict`` of ``ParameterDict``s per layer."""
    return nn.ModuleList(nn.ModuleDict({part: _param_dict(sub)
                                        for part, sub in layer.items()})
                         for layer in layers)


class LM(nn.Module):
    """A language model of any family: ``embed``, ``final_norm``,
    ``lm_head`` (unless tied) and ``blocks``, one ``ModuleDict`` of
    ``ParameterDict``s per layer ("mix"; "ffn" but for RWKV layers; "cross"
    in an encoder-decoder), the dense prefix first; an encoder-decoder adds
    ``encoder`` (its layers, "mix" and "ffn") and ``enc_norm``, a VLM
    ``img_proj``.  The parameters are wrapped, not copied, so tensors
    shared between layers stay shared.  They need no gradient until
    ``requires_grad_(True)`` (training); ``param_list`` orders them."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = _frozen(params["lm_head"]) if "lm_head" in params \
            else None
        self.blocks = _layers(params["blocks"])
        self.encoder = _layers(params.get("encoder", []))
        self.enc_norm = _frozen(params["enc_norm"]) \
            if "enc_norm" in params else None
        self.img_proj = _frozen(params["img_proj"]) \
            if "img_proj" in params else None

    @classmethod
    def init(cls, cfg: ArchConfig, generator: torch.Generator,
             device="cuda") -> "LM":
        return cls(cfg, init_params(cfg, generator, device))

    @classmethod
    def from_reference(cls, cfg: ArchConfig, tree: dict,
                       device="cuda") -> "LM":
        return cls(cfg, params_from_reference(cfg, tree, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_list(self) -> list:
        """Every parameter once, in registration order: the fixed order of
        the optimiser's moments and of a checkpoint's leaves."""
        return list(self.parameters())

    @classmethod
    def from_named(cls, cfg: ArchConfig, named) -> "LM":
        """The model over the tensors of ``named``, (dotted name, tensor)
        pairs as ``named_parameters`` gives them (``blocks.0.mix.wq``):
        each tensor wrapped, not copied."""
        tree: dict = {}
        for name, t in named:
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t

        def lists(node):   # {"0": layer, "1": layer} -> [layer, layer]
            if not isinstance(node, dict):
                return node
            if all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}

        return cls(cfg, lists(tree))

    def forward(self, batch):
        return forward(self.cfg, self, batch)

    def init_cache(self, B: int, Smax: int):
        return init_cache(self.cfg, B, Smax, self.device)

    def decode_step(self, cache, batch):
        return decode_step(self.cfg, self, cache, batch)


# ---------------------------------------------------------------------------
# weights gathered at their use (a sharded step)
# ---------------------------------------------------------------------------

_GATHER: list = []


@contextlib.contextmanager
def gathering(fn):
    """Inside, every weight the layers and the model read is ``fn(w)``,
    taken where it is used: a sharded step's all-gather of the rank's
    shard (``launch.steps``).  The backward of a layer recomputed under
    ``_remat`` runs ``fn`` again, so the backward must run inside too."""
    _GATHER.append(fn)
    try:
        yield
    finally:
        _GATHER.pop()


def _use(w):
    """A model-level weight (the embedding, the head, a norm) as the
    installed gathering gives it, or ``w`` itself."""
    return _GATHER[-1](w) if _GATHER else w


def _use_layer(p):
    """A layer's weights (its nested dicts of parts) as the installed
    gathering gives them, or ``p`` itself."""
    if not _GATHER:
        return p
    return {k: _use_layer(v) if isinstance(v, (dict, nn.Module))
            else _GATHER[-1](v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _apply_layer(cfg, spec, p, x, positions, enc_out=None):
    mix, ffn = spec
    p = _use_layer(p)
    if mix == "attn":
        x = L.attn_forward(cfg, p["mix"], x, positions)
    elif mix == "mla":
        x = L.mla_forward(cfg, p["mix"], x, positions)
    elif mix == "mamba":
        x = L.mamba_forward(cfg, p["mix"], x)
    elif mix == "rwkv":
        x = L.rwkv_forward(cfg, p["mix"], x)
    if enc_out is not None and "cross" in p:
        x = L.cross_attn_forward(cfg, p["cross"], x, enc_out)
    if ffn == "moe":
        x = L.moe_forward(cfg, p["ffn"], x)
    elif ffn == "mlp":
        x = L.mlp_forward(cfg, p["ffn"], x)
    return x


# the reference's "dots" policy (checkpoint_dots_with_no_batch_dims): the
# plain matrix products, which ``x @ w`` becomes, are saved; a product with
# a batch dim (``bmm``: the attention's scores and weighted values) is not
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _SaveDots(TorchDispatchMode):
    """A "dots" layer's forward: every ``_DOTS`` result is kept (detached,
    in call order) in ``saved``; nothing else is."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self.saved.append(out.detach())
        return out


class _ReuseDots(TorchDispatchMode):
    """The same layer's recompute in the backward: each ``_DOTS`` call
    hands back the forward's product (released as it is taken), every other
    op runs again."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved
        self.taken = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS:
            return func(*args, **(kwargs or {}))
        out, self.saved[self.taken] = self.saved[self.taken], None
        self.taken += 1
        return out


def _dots_contexts():
    """``checkpoint``'s (forward, recompute) contexts for "dots".  Not
    ``create_selective_checkpoint_contexts``: under a proxy mode
    (``make_fx``, the dry-run) PyTorch's caches every op's result, leaving
    the partitioning to a compiler, and the traced backward then reads the
    softmax's score-sized tensors from the forward."""
    saved: list = []
    return _SaveDots(saved), _ReuseDots(saved)


def _remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` when grad is enabled (the
    reference's ``_remat``, one layer at a time): "full" recomputes the
    layer in the backward, "dots" recomputes all but its plain matrix
    products, "none" (or no grad) runs it as is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=_dots_contexts)
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: none, full or dots")
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


def backbone(cfg: ArchConfig, model: LM, x, positions, enc_out=None):
    """Apply every layer in order + final norm.  x: (B,S,D); positions:
    (B,S), or None for ``arange(S)`` in every row; enc_out: the encoder's
    output (encdec), or None.  Each layer under ``_remat``."""
    for spec, p in zip(layer_specs(cfg), model.blocks):
        x = _remat(cfg, functools.partial(_apply_layer, cfg, spec), p, x,
                   positions, enc_out)
    return L.rms_norm(x, _use(model.final_norm), cfg.norm_eps)


def encode(cfg: ArchConfig, model: LM, frames):
    """The Whisper encoder over (stub) frame embeddings (B, T, D), in the
    model's dtype: non-causal attention (rope over ``arange(T)``, plain
    ``_sdpa``) and an MLP a layer, then ``enc_norm``."""
    x = _on(frames, model.device).to(model.embed.dtype)
    for p in model.encoder:
        x = _remat(cfg, _encoder_layer, cfg, p, x)
    return L.rms_norm(x, _use(model.enc_norm), cfg.norm_eps)


def _encoder_layer(cfg, p, x):
    p = _use_layer(p)
    x = L.attn_forward(cfg, p["mix"], x, None, causal=False)
    return L.mlp_forward(cfg, p["ffn"], x)


def logits_from_hidden(cfg: ArchConfig, model: LM, h):
    """The logits of the hidden states; under a tensor-parallel step whose
    head holds the rank's share of the vocabulary, the rank's columns."""
    head = _use(model.embed).T if cfg.tie_embeddings else _use(model.lm_head)
    ax = tp.split(head.shape[1], cfg.vocab)
    if ax is not None:
        h = tp.enter(h, ax)
    logits = h @ head
    return logits.float() if cfg.logits_fp32 else logits


def embed_inputs(cfg: ArchConfig, model: LM, batch):
    """Token ids (+ the modality stubs' embeddings) -> (x, positions,
    enc_out).  The positions are ``arange`` over the sequence in every row,
    given as None: the layers build them, and the chunked attention then
    needs no check that they are an arange.  An encdec batch's ``frames``
    go through the encoder (``enc_out``, else None); a vlm batch's
    ``patches`` (B, n_img_tokens, D), projected by ``img_proj``, go before
    the token embeddings.  Under a tensor-parallel step whose table holds
    the rank's rows of the vocabulary, the lookup is vocabulary-parallel
    (``tensor_parallel.embed``), and where ``img_proj`` holds the rank's
    columns the projected patches are gathered whole before the
    concatenation."""
    tokens = _on(batch["tokens"], model.device)
    x = _embed(cfg, model, tokens)
    enc_out = encode(cfg, model, batch["frames"]) \
        if cfg.family == "encdec" else None
    if cfg.family == "vlm":
        proj = _use(model.img_proj)
        img = _on(batch["patches"], model.device).to(x.dtype) @ proj
        ax = tp.split(proj.shape[1], cfg.d_model)
        if ax is not None:
            img = tp.gather(img, ax)
        x = torch.cat([img, x], dim=1)
    return x, None, enc_out


def _embed(cfg: ArchConfig, model: LM, tokens):
    """The token embeddings; vocabulary-parallel
    (``tensor_parallel.embed``) where the table holds the rank's rows."""
    table = _use(model.embed)
    ax = tp.split(table.shape[0], cfg.vocab)
    return table[tokens] if ax is None else tp.embed(table, tokens, ax)


def _logits(cfg: ArchConfig, model: LM, batch):
    """(the logits over the text positions, the model axis their vocabulary
    is split over or None)."""
    x, positions, enc_out = embed_inputs(cfg, model, batch)
    h = backbone(cfg, model, x, positions, enc_out)
    if cfg.family == "vlm":          # logits over the text positions only
        h = h[:, cfg.n_img_tokens:]
    logits = logits_from_hidden(cfg, model, h)
    return logits, tp.split(logits.shape[-1], cfg.vocab)


def forward(cfg: ArchConfig, model: LM, batch):
    """batch: {tokens: (B, S) int}, with ``frames`` (B, T, D) for encdec
    and ``patches`` (B, n_img_tokens, D) for vlm.  Returns logits (B, S, V)
    over the text positions (under a tensor-parallel step, the ranks'
    columns gathered)."""
    logits, ax = _logits(cfg, model, batch)
    return logits if ax is None else tp.gather(logits, ax)


def loss_terms(cfg: ArchConfig, model: LM, batch):
    """(the sum over ``mask`` (ones when the batch has none) of
    ``-log_softmax(logits)`` at ``labels`` (B, S), the mask's sum): the
    loss's numerator and token count, 0-d tensors on the model's device.  A
    sharded step sums both over its ranks before it divides; under a
    tensor-parallel step the log-softmax is taken from the rank's columns
    of the logits (``tensor_parallel.log_prob``)."""
    logits, ax = _logits(cfg, model, batch)
    labels = _on(batch["labels"], model.device).long()
    if ax is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    else:
        ll = tp.log_prob(logits, labels, ax)
    mask = _on(batch["mask"], model.device) if "mask" in batch \
        else torch.ones_like(ll)
    return -(ll * mask).sum(), mask.sum()


def loss_fn(cfg: ArchConfig, model: LM, batch):
    """The reference's training loss: the masked mean of
    ``loss_terms``, as a 0-d tensor on the model's device."""
    total, count = loss_terms(cfg, model, batch)
    return total / torch.clamp(count, min=1.0)


def opt_state_from_reference(cfg: ArchConfig, state: dict,
                             device="cuda") -> dict:
    """The port's AdamW state from the reference's (``repro.optim``'s
    ``adamw_init`` or ``adamw_update`` output, as numpy arrays): ``m`` and
    ``v`` as lists in ``LM.param_list`` order, each moment in its own
    dtype, ``count`` a 0-d int32 tensor."""
    def ordered(tree):
        return [t.detach() for t in
                LM(cfg, params_from_reference(cfg, tree, device)).param_list()]

    return {"m": ordered(state["m"]), "v": ordered(state["v"]),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# decode (one token, KV/state caches)
# ---------------------------------------------------------------------------


def _on(t, device: torch.device) -> torch.Tensor:
    """An index array as a tensor on ``device`` (numpy input is copied)."""
    return torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                           else t, device=device)


def init_cache(cfg: ArchConfig, B: int, Smax: int, device="cuda"):
    """{"blocks": [per-layer cache]}: attention layers hold {k, v}
    (B, Smax, K, hd), MLA layers {ckv} (B, Smax, kv_lora + rope_hd), Mamba
    layers {h (B, di, N) f32, tail (B, kc-1, di)}, RWKV layers {shift_a,
    shift_f, s}."""
    dt = L._dt(cfg)
    dev = torch.device(device)
    blocks = []
    for mix, _ in layer_specs(cfg):
        if mix == "attn":
            blocks.append(L.init_attn_cache(cfg, B, Smax, dt, dev))
        elif mix == "mla":
            blocks.append(L.init_mla_cache(cfg, B, Smax, dt, dev))
        elif mix == "mamba":
            blocks.append(L.init_mamba_cache(cfg, B, dt, dev))
        elif mix == "rwkv":
            blocks.append(L.init_rwkv_cache(cfg, B, dt, dev))
        else:
            raise ValueError(f"{cfg.name}: no cache for layer kind {mix!r}")
    return {"blocks": blocks}


def _decode_layer(cfg, spec, p, x, cache, pos, enc_out, in_place):
    mix, ffn = spec
    p = _use_layer(p)
    if mix == "attn":
        x, cache = L.attn_decode(cfg, p["mix"], x, cache, pos)
    elif mix == "mla":
        x, cache = L.mla_decode(cfg, p["mix"], x, cache, pos)
    elif mix == "mamba":
        x, cache = L.mamba_decode(cfg, p["mix"], x, cache)
    elif mix == "rwkv":
        x, cache = L.rwkv_decode(cfg, p["mix"], x, cache, in_place=in_place)
    if enc_out is not None and "cross" in p:
        x = L.cross_attn_forward(cfg, p["cross"], x, enc_out)
    if ffn == "moe":
        x = L.moe_forward(cfg, p["ffn"], x)
    elif ffn == "mlp":
        x = L.mlp_forward(cfg, p["ffn"], x)
    return x, cache


def _decode(cfg: ArchConfig, model: LM, cache, batch, in_place: bool):
    dev = model.device
    tok = _on(batch["token"], dev)
    pos = _on(batch["pos"], dev)
    x = _embed(cfg, model, tok)
    enc_out = encode(cfg, model, batch["frames"]) \
        if cfg.family == "encdec" else None
    blocks = []
    for spec, p, c in zip(layer_specs(cfg), model.blocks, cache["blocks"]):
        x, c = _decode_layer(cfg, spec, p, x, c, pos, enc_out, in_place)
        blocks.append(c)
    h = L.rms_norm(x, _use(model.final_norm), cfg.norm_eps)
    logits = logits_from_hidden(cfg, model, h)
    ax = tp.split(logits.shape[-1], cfg.vocab)
    return logits if ax is None else tp.gather(logits, ax), \
        {"blocks": blocks}


def decode_step(cfg: ArchConfig, model: LM, cache, batch):
    """batch: {token: (B,1) int, pos: (B,) int}, with ``frames`` (B, T, D)
    for encdec (encoded at every step, as the reference does; a vlm's
    decode takes no patches).  Returns (logits (B,1,V), new cache).
    Attention and MLA caches are written in place (see
    ``layers.attn_decode``, ``layers.mla_decode``); Mamba and RWKV states
    are replaced, so the caller's cache keeps its own.  Under a sharded
    decode step (``launch.steps``) the layers compute on the rank's shards
    and the logits' vocabulary is gathered."""
    return _decode(cfg, model, cache, batch, in_place=False)


def decode_step_into(cfg: ArchConfig, model: LM, cache, batch):
    """``decode_step`` that leaves every state in ``cache``'s own tensors:
    the WKV kernel updates each RWKV layer's state in place, and the
    states the step replaces (RWKV's token shifts, Mamba's state and conv
    tail) are copied back into the tensors they replace.  Returns (logits,
    ``cache``, the same object), so a caller that holds the cache's
    storage (a CUDA graph, a batcher) sees each step's states there."""
    logits, new = _decode(cfg, model, cache, batch, in_place=True)
    for old, cur in zip(cache["blocks"], new["blocks"]):
        for name, t in cur.items():
            if t is not old[name]:
                old[name].copy_(t)
    return logits, cache


# the kernel wrappers' launch counters, by module
_LAUNCH_COUNTERS = {"flash_attention": flash_attention.LAUNCHES,
                    "wkv6": wkv6.LAUNCHES}
# kernel launches run by graph replays, "<module>/<wrapper key>" (the
# wrappers count only the launches they make themselves)
GRAPH_LAUNCHES: collections.Counter = collections.Counter()


class DecodeGraph:
    """The decode step of one batch size over one cache, captured once as a
    CUDA graph and replayed for every token: the counterpart of the
    reference's ``@jax.jit`` decode step.

    Its static inputs are the (B, 1) token and (B,) position buffers, one
    buffer for each of the batch's other keys given in ``extra`` (an
    encdec step's ``frames``; copies of the tensors given), and ``cache``
    itself.  A call ``graph(cache, token, pos, **extra)`` copies token,
    pos and each extra input given into the static buffers (one not given
    keeps its last value), replays the graph and returns the logits (a
    static buffer, overwritten by the next replay) and ``cache``, the same
    object: every state is written in place (``decode_step_into``), so
    writes between calls, such as a batcher resetting a slot's rows, reach
    the next replay.

    Construction runs ``warmup`` eager steps on a side stream (they load
    the kernels and fill PyTorch's caches, which capture may not do),
    captures one step and puts the cache back as it was.  A capture that
    fails raises.  Capture records kernel launches without running them,
    so the wrappers' counts of the captured step are taken off again and
    kept as ``launches_per_replay``; every replay adds them to
    ``GRAPH_LAUNCHES``."""

    warmup = 2

    def __init__(self, cfg: ArchConfig, model: LM, cache,
                 extra: dict | None = None):
        dev = model.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs the card; the model is on "
                             f"{dev} (call decode_step there)")
        self.cfg, self.model, self.cache = cfg, model, cache
        B = next(iter(cache["blocks"][0].values())).shape[0]
        with torch.inference_mode():
            self.token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.extra = {k: _on(t, dev).clone()
                          for k, t in (extra or {}).items()}
            saved = [{k: t.clone() for k, t in c.items()}
                     for c in cache["blocks"]]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.warmup):
                    self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
            before = {m: collections.Counter(c)
                      for m, c in _LAUNCH_COUNTERS.items()}
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = self._step()
            self.launches_per_replay = collections.Counter()
            for m, c in _LAUNCH_COUNTERS.items():
                for key, n in (c - before[m]).items():
                    self.launches_per_replay[f"{m}/{key}"] = n
                c.clear()
                c.update(before[m])
            for c, s in zip(cache["blocks"], saved):
                for k, t in s.items():
                    c[k].copy_(t)
        self.replays = 0

    def _step(self):
        return decode_step_into(self.cfg, self.model, self.cache,
                                {"token": self.token, "pos": self.pos,
                                 **self.extra})[0]

    def __call__(self, cache, token, pos, **extra):
        if cache is not self.cache:
            raise ValueError("DecodeGraph: called with another cache than "
                             "the one it was captured over")
        if extra.keys() - self.extra.keys():
            raise ValueError(f"DecodeGraph: inputs {sorted(extra)}; it was "
                             f"captured with {sorted(self.extra)}")
        self.token.copy_(token)
        self.pos.copy_(pos)
        for k, t in extra.items():
            self.extra[k].copy_(_on(t, self.extra[k].device))
        self.graph.replay()
        self.replays += 1
        GRAPH_LAUNCHES.update(self.launches_per_replay)
        return self.logits, self.cache
