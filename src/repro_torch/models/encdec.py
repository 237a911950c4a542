"""Encoder-decoder backbone, in PyTorch (port of ``repro.models.encdec``):
SeamlessM4T-v2 style, the audio frontend stubbed.

The speech frontend (mel filterbank + conformer feature extractor) is a
stub, as in the reference: the batch carries precomputed frame
embeddings (B, F, d_model).  The encoder is a bidirectional Transformer
over those frames (RoPE over the F frame positions); the decoder is
causal, with a self-attention ring cache and cross-attention to the
encoder output, whose K/V are projected once per prefill and kept in the
cache.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device

from .arch import (StepSpecs, _embed, _logits, _no_tf32, add_params,
                   base_batch_axes, base_batch_specs, ce_loss, draw_params,
                   embed_specs, global_ce, kv_seq_axis, own_params,
                   ring_axis, stack_specs, whole, zeros_from_specs)
from .config import InputShape, ModelConfig
from .layers import (DTYPES, ParamSpec, attention, attention_specs, cross_kv,
                     ffn, ffn_specs, rms_norm)
from .partitioning import checkpoint_in_rules, local_spec_tree


EMBED = ("tok", "final_norm", "unembed")     # the decoder's top-level weights


class EncDecModel(StepSpecs, nn.Module):
    """``n_enc_layers`` encoder blocks over the frames, ``n_layers``
    decoder blocks (self-attention, cross-attention, FFN).

    Parameters live on ``device`` from construction under the reference
    tree's names (``encoder.attn.wq``, ``decoder.xattn.wk``,
    ``enc_norm``; each block stacked (layers, ...)); ``init`` fills them
    from a ``torch.Generator``, ``convert.load_jax_params`` loads a
    ``repro`` tree.  Public layouts are the reference's:

    * cache ``{"self": (k, v), "cross": (ek, ev)}``, k, v (n_layers, B,
      S, KV, D) the decoder's ring, ek, ev (n_layers, B, F, KV, D) the
      encoder output's projection by each layer's ``xattn`` (from the
      encoder output itself: ``lnx`` normalises only the decoder
      stream);
    * ``prefill({"frames": (B, F, d), "tokens": (B, S)})`` and
      ``decode_step(cache, {"token": (B, 1), "pos": (B,)})`` return
      (logits (B, 1, vocab_padded), cache);
    * ``loss({"frames", "tokens", "labels"})`` returns (CE, {"ce"}).

    ``decode_step`` writes the new K/V into the caller's self ring IN
    PLACE and reads the cross K/V as they are; it returns the same
    tensors.  On a CUDA model each decoder layer of a step launches
    ``decode_attn`` twice: over the self ring and over the F encoder
    slots.

    Under a process mesh every attention (the encoder's, the decoder's
    causal one and the cross-attention) runs on this rank's heads
    (``layers.attention``), the cross K/V are projected onto its kv
    heads (``layers.cross_kv``) and cached so, and the vocabulary is
    sharded as the other families' is."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _no_tf32()
        self.cfg = cfg
        self.device = resolve_device(device)
        add_params(self, self.param_specs(), self.device)

    def enc_block_specs(self):
        d = self.cfg.d_model
        return {
            "ln1": ParamSpec((d,), ("embed",), init="ones"),
            "ln2": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attention_specs(self.cfg),
            "ffn": ffn_specs(self.cfg),
        }

    def dec_block_specs(self):
        d = self.cfg.d_model
        return {
            "ln1": ParamSpec((d,), ("embed",), init="ones"),
            "lnx": ParamSpec((d,), ("embed",), init="ones"),
            "ln2": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attention_specs(self.cfg),
            "xattn": attention_specs(self.cfg),
            "ffn": ffn_specs(self.cfg),
        }

    def param_specs(self):
        cfg = self.cfg
        specs = dict(embed_specs(cfg))
        specs["encoder"] = stack_specs(self.enc_block_specs(),
                                       cfg.n_enc_layers)
        specs["decoder"] = stack_specs(self.dec_block_specs(), cfg.n_layers)
        specs["enc_norm"] = ParamSpec((cfg.d_model,), ("embed",),
                                      init="ones")
        return specs

    def init(self, generator: torch.Generator) -> "EncDecModel":
        """Draw every parameter on the CPU from ``generator``, in
        sorted-name order."""
        return draw_params(self, generator)

    # --- encoder --------------------------------------------------------------
    def _enc_block(self, l, x, positions):
        cfg = self.cfg
        pl = self.encoder.tree(l)
        h, _ = attention(pl["attn"], rms_norm(x, pl["ln1"]), cfg,
                         positions=positions, causal=False)
        x = x + h
        return x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), cfg)

    def _encode(self, frames, remat=False):
        """frames (B, F, d) -> the normed encoder output (B, F, d):
        bidirectional self-attention, RoPE over the F positions.
        ``remat`` runs each layer under ``torch.utils.checkpoint``."""
        x = torch.as_tensor(frames, device=self.device)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        for l in range(self.cfg.n_enc_layers):
            x = checkpoint_in_rules(self._enc_block, l, x, positions) \
                if remat else self._enc_block(l, x, positions)
        return rms_norm(x, whole(self, "enc_norm"))

    @torch.no_grad()
    def encode(self, frames):
        """``_encode`` without a gradient (the serve path)."""
        return self._encode(frames)

    # --- decoder --------------------------------------------------------------
    def _dec_block(self, pl, x, positions, enc=None, self_cache=None,
                   xkv=None, cache_index=None, seq_axis=None):
        """One decoder layer: (x, its self K/V, its cross K/V), the cross
        K/V projected from ``enc`` when ``xkv`` is None."""
        cfg = self.cfg
        h, kvc = attention(pl["attn"], rms_norm(x, pl["ln1"]), cfg,
                           positions=positions, cache=self_cache,
                           cache_index=cache_index, seq_axis=seq_axis)
        x = x + h
        if xkv is None:                   # the cross K/V from the encoder
            ek, ev = cross_kv(pl["xattn"], enc, cfg)
        else:
            ek, ev = xkv
        h, _ = attention(pl["xattn"], rms_norm(x, pl["lnx"]), cfg,
                         positions=positions, kv_override=(ek, ev),
                         causal=False)
        x = x + h
        x = x + ffn(pl["ffn"], rms_norm(x, pl["ln2"]), cfg)
        return x, kvc, (ek, ev)

    def _dec_run(self, x, positions, enc=None, self_cache=None,
                 cross_kv=None, cache_index=None, remat=False, seq_axis=None):
        """The decoder layers in turn.  Prefill (``enc`` given): every
        layer's self K/V and its cross K/V (projected from ``enc``) are
        copied into stacked (n_layers, ...) pairs.  Decode: layer l
        writes its ring slice of ``self_cache`` in place and reads
        ``cross_kv``'s slice; the same tuples come back.  ``remat`` (the
        loss path, ``enc`` given) runs each layer under
        ``torch.utils.checkpoint``, keeps no K/V and returns (x, None,
        None)."""
        L = self.cfg.n_layers
        if remat:
            for l in range(L):
                x = checkpoint_in_rules(lambda xc, e, l=l: self._dec_block(
                    self.decoder.tree(l), xc, positions, enc=e)[0], x, enc)
            return x, None, None
        kv, xkv = self_cache, cross_kv
        for l in range(L):
            sc = None if self_cache is None else tuple(t[l] for t in self_cache)
            ckv = None if cross_kv is None else tuple(t[l] for t in cross_kv)
            x, kvc, ekv = self._dec_block(self.decoder.tree(l), x, positions,
                                          enc, sc, ckv, cache_index, seq_axis)
            if self_cache is None:
                if kv is None:
                    kv = tuple(torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                                           device=t.device) for t in kvc)
                    xkv = tuple(torch.empty((L,) + tuple(t.shape),
                                            dtype=t.dtype, device=t.device)
                                for t in ekv)
                for dst, src in zip(kv + xkv, kvc + ekv):
                    dst[l] = src
        return x, kv, xkv

    # --- public protocol ------------------------------------------------------
    def loss(self, batch):
        """{"frames": (B, F, d) (cast to the model's type), "tokens":
        (B, S), "labels": (B, S)} -> (CE, {"ce"}): the encoder and the
        decoder each rematerialised layer by layer, the chunked CE."""
        frames = torch.as_tensor(batch["frames"], device=self.device)
        vp = self.cfg.vocab_padded
        enc = self._encode(frames.to(self.tok.dtype), remat=True)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        top = own_params(self, names=EMBED)
        x = _embed(top["tok"], tokens, vp)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, _, _ = self._dec_run(x, positions, enc=enc, remat=True)
        ce = ce_loss(top["final_norm"], top["unembed"], x, labels,
                     self.cfg.vocab, vp=vp)
        return ce, {"ce": global_ce(ce)}

    @torch.no_grad()
    def prefill(self, batch):
        """{"frames": (B, F, d) (cast to the model's type), "tokens":
        (B, S)} -> (last-position logits, cache)."""
        frames = torch.as_tensor(batch["frames"], device=self.device)
        vp = self.cfg.vocab_padded
        enc = self.encode(frames.to(self.tok.dtype))
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        top = own_params(self, names=EMBED)
        x = _embed(top["tok"], tokens, vp)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, kv, xkv = self._dec_run(x, positions, enc=enc)
        return _logits(top["final_norm"], top["unembed"], x[:, -1:], vp), \
            {"self": kv, "cross": xkv}

    @torch.no_grad()
    def decode_step(self, cache, batch, seq_len=None):
        """One token per sequence: {"token": (B, 1), "pos": (B,)} against
        ``cache`` -> (logits (B, 1, Vp), the same cache, its self ring
        updated).  ``seq_len`` as the Transformer's: it tells a
        kv_seq-sharded self ring."""
        vp = self.cfg.vocab_padded
        token = torch.as_tensor(batch["token"], device=self.device).long()
        pos = torch.as_tensor(batch["pos"], device=self.device)
        sa = ring_axis(token.shape[0], cache["self"][0].shape[2], seq_len,
                       seq_len)
        top = own_params(self, names=EMBED)
        x = _embed(top["tok"], token, vp)
        x, kv, xkv = self._dec_run(x, pos[:, None],
                                   self_cache=tuple(cache["self"]),
                                   cross_kv=tuple(cache["cross"]),
                                   cache_index=pos, seq_axis=sa)
        return _logits(top["final_norm"], top["unembed"], x, vp), \
            {"self": kv, "cross": xkv}

    def cache_specs(self, batch: int, seq_len: int):
        """The cache's (shape, dtype) tree (no sharding axes)."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        kv = ((cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim), dt)
        xkv = ((cfg.n_layers, batch, cfg.n_frontend_tokens, cfg.n_kv_heads,
                cfg.head_dim), dt)
        return {"self": (kv, kv), "cross": (xkv, xkv)}

    def cache_axes(self, batch: int, seq_len: int):
        """The logical axes of ``cache_specs``' leaves."""
        kv = ("layers", "batch", kv_seq_axis(batch, seq_len), "kv_heads", None)
        xkv = ("layers", "batch", None, "kv_heads", None)
        return {"self": (kv, kv), "cross": (xkv, xkv)}

    def init_cache(self, batch: int, seq_len: int):
        """Zeros of ``cache_specs``; under a process mesh this rank's
        shard."""
        return zeros_from_specs(local_spec_tree(
            self.cache_specs(batch, seq_len),
            self.cache_axes(batch, seq_len)), self.device)

    def batch_specs(self, shape: InputShape):
        """The entry point's batch as {name: (shape, dtype)}: the base
        specs, plus ``frames`` (B, F, d) outside decode."""
        specs = base_batch_specs(shape)
        if shape.kind != "decode":
            specs["frames"] = ((shape.global_batch, self.cfg.n_frontend_tokens,
                                self.cfg.d_model), DTYPES[self.cfg.dtype])
        return specs

    def batch_axes(self, shape: InputShape):
        axes = base_batch_axes(shape)
        if shape.kind != "decode":
            axes["frames"] = ("batch", "frames", "embed")
        return axes
