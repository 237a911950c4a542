# Copied from src/repro/models/config.py (pure Python): only module paths are renamed repro -> repro_torch.
"""Model configuration for every architecture family the framework serves.

A single ``ModelConfig`` dataclass describes dense decoders, MoE decoders,
SSM (Mamba2 / RWKV6) stacks, hybrid SSM+attention stacks, encoder-decoder
(audio) backbones and VLM decoders.  ``family`` selects the block wiring;
the remaining fields parameterize the blocks.

Conventions
-----------
* ``head_dim`` defaults to ``d_model // n_heads`` unless set explicitly.
* ``vocab_padded`` rounds the vocabulary up to a multiple of 256 so the
  embedding/output projection shards evenly over a 16-way model axis
  (Megatron-style vocab padding; logits beyond ``vocab`` are masked).
* MoE: ``n_experts`` routed experts with per-expert FFN width
  ``d_expert``; ``n_shared_experts`` always-on shared experts; ``top_k``
  routing.  ``d_ff`` is the dense-FFN width used by non-MoE layers (or by
  the shared expert when ``d_expert`` differs).
* SSM (mamba2): ``ssm_state`` is the per-head state width N; d_inner =
  ``ssm_expand * d_model``; ``ssm_head_dim`` the value head dim P.
* Hybrid (zamba2): ``attn_every`` inserts one shared-weight GQA block
  after every ``attn_every`` mamba blocks.
* enc-dec: ``n_enc_layers`` encoder layers; decoder uses ``n_layers``.
* VLM / audio: ``n_frontend_tokens`` precomputed patch/frame embeddings
  prepended to the token sequence (the frontend itself is stubbed per the
  assignment: ``input_specs`` provides embeddings of the right shape).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm_mamba2 | ssm_rwkv6 | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # ffn
    d_ff: int = 0
    act: str = "silu"
    glu: bool = True
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    router_aux_coef: float = 0.01
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid
    attn_every: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stub (audio frames / vision patches)
    n_frontend_tokens: int = 0
    # long-context: sliding-window size used for the long_500k decode shape
    # (dense archs only run long_500k when this is non-zero)
    sliding_window: int = 0
    # pad attention heads up to this count (Megatron-style padding so an
    # awkward head count shards over the model axis; padded heads are
    # masked out of the output and receive no gradient)
    head_pad: int = 0
    # q-chunked attention: chunk the query axis in lax.map blocks of this
    # size when S >= 4*chunk (caps the materialized score tile; the real
    # TPU path uses the Pallas flash kernels instead)
    attn_q_chunk: int = 0
    # route HSTU attention through the Pallas kernels (TPU serving path;
    # on CPU they run in interpret mode — slow but bit-checked)
    use_flash_kernels: bool = False
    # int8 KV cache (symmetric, static scale): halves the decode-path
    # HBM stream — the dominant roofline term of every decode shape
    kv_quant: bool = False
    # numerics
    dtype: str = "bfloat16"
    # HSTU-style pointwise attention (generative recommendation backbone)
    hstu: bool = False
    # ranking head: number of task-tower outputs (GR ranking); 0 = LM head
    n_tasks: int = 0
    source: str = ""  # citation

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family in ("ssm_mamba2", "ssm_rwkv6")

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can run the 500k-token decode shape."""
        return (
            self.family in ("ssm_mamba2", "ssm_rwkv6", "hybrid")
            or self.sliding_window > 0
        )

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no decode step (none assigned here)."""
        return True

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_padded
        n = 0
        n += v * d  # embedding
        n += v * d  # unembedding (untied)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            hd = self.head_dim
            per_layer += d * self.n_heads * hd  # q
            per_layer += 2 * d * self.n_kv_heads * hd  # k, v
            per_layer += self.n_heads * hd * d  # o
            per_layer += 2 * d  # norms
            if self.family == "moe":
                de = self.d_expert
                per_layer += self.n_experts * (3 * d * de)
                per_layer += self.n_shared_experts * (3 * d * de)
                per_layer += d * self.n_experts  # router
            else:
                mult = 3 if self.glu else 2
                per_layer += mult * d * self.d_ff
            n += self.n_layers * per_layer
            if self.family == "encdec":
                # encoder layers + cross-attention in decoder
                enc = self.n_enc_layers * (
                    4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
                )
                xattn = self.n_layers * (
                    d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d + d
                )
                n += enc + xattn
        elif self.family == "ssm_mamba2":
            di, ns = self.d_inner, self.ssm_state
            per_layer = d * (2 * di + 2 * ns * 1 + self.n_ssm_heads)  # in_proj approx
            per_layer += d * 2 * di + di * d + 3 * d * self.d_ff + 2 * d
            n += self.n_layers * per_layer
        elif self.family == "ssm_rwkv6":
            mult = 3 if self.glu else 2
            per_layer = 5 * d * d + 2 * d * 64 + mult * d * self.d_ff + 2 * d
            n += self.n_layers * per_layer
        elif self.family == "hybrid":
            di = self.d_inner
            per_layer = d * 2 * di + di * d + 3 * d * self.d_ff + 2 * d
            n += self.n_layers * per_layer
            hd = self.head_dim
            n += 4 * d * self.n_heads * hd  # one shared attention block
        if self.hstu:
            # HSTU blocks: f1 produces U,V,Q,K (4x), f2 back
            n = v * d + self.n_layers * (4 * d * d + d * d + 2 * d)
            if self.n_tasks:
                n += d * 4 * d + 4 * d * self.n_tasks
        return n


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
