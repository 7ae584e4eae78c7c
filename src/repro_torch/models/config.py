"""Model configuration for the assigned-architecture zoo.

One ``ModelConfig`` describes any of the ten architectures (dense GQA, MoE,
RWKV6, Mamba-hybrid, encoder–decoder, VLM/audio backbones).  Layers are
described by per-layer ``LayerSpec``s; the transformer stacks parameters over
the smallest repeating period and loops over the groups.

A copy of ``repro.models.config``, equal to it field for field, so a config
means the same in both packages.  ``mamba_scan`` and ``mamba_chunk`` pick
XLA lowerings of the Mamba scan in the JAX package; the port ignores them:
its scan is the ``ssm_scan`` CUDA kernel on the card and the plain loop on
the CPU (``repro_torch.kernels.ssm_scan``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    every: int = 1                 # MoE on every Nth layer (jamba: 2)
    shared_expert: bool = False    # llama4-style always-on shared expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # attn | mamba | rwkv
    mlp: str = "dense"             # dense | moe
    window: Optional[int] = None   # sliding-window width for local attention
    cross_attn: bool = False       # decoder layers attending to an encoder


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    act: str = "silu"
    glu: bool = True                        # gated MLP (SwiGLU/GeGLU)
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    post_norms: bool = False                # gemma2 extra post-norms
    pos: str = "rope"                       # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # qwen2-vl t/h/w split
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    embed_scale: bool = False               # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    local_global_pattern: Optional[int] = None  # gemma2: every Nth is global
    window: Optional[int] = None                # width of local layers
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    attn_every: int = 1             # jamba: attention on every Nth layer,
    rwkv: Optional[RWKVCfg] = None  # mamba elsewhere (1 => all-attention)
    mamba_scan: str = "assoc"       # assoc | unroll (perf A/B, §Perf:
    mamba_chunk: int = 256          # unroll loses at XLA op granularity)
    attn_chunk_threshold: int = 8192  # KV len above which attention chunks
    moe_grouped_dispatch: bool = True  # route per batch element (GShard
    #                                    groups): keeps dispatch shard-local
    attn_scores_f32: bool = True    # False: bf16 score materialization
    #                                 (flash-attention traffic proxy, §Perf)
    n_micro_override: Optional[int] = None  # force grad-accum factor
    encoder_layers: int = 0         # >0 => encoder-decoder (whisper)
    input_mode: str = "tokens"      # tokens | embeds (vlm/audio stub frontends)
    max_seq: int = 32_768
    dtype: str = "bfloat16"
    optimizer: str = "adamw"        # adamw | adafactor (biggest configs)
    supports_long_context: bool = False  # may run the long_500k decode cell
    vocab_pad_multiple: int = 256   # pad embed/unembed for TP divisibility
    notes: str = ""

    # ------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self) -> List[LayerSpec]:
        """Decoder layer specs (encoders are uniform bidir attention)."""
        specs = []
        for i in range(self.n_layers):
            if self.rwkv is not None:
                mixer = "rwkv"
            elif self.mamba is not None and self.attn_every > 1:
                mixer = "attn" if (i % self.attn_every == self.attn_every - 1) \
                    else "mamba"
            elif self.mamba is not None:
                mixer = "mamba"
            else:
                mixer = "attn"
            window = None
            if mixer == "attn" and self.local_global_pattern:
                if i % self.local_global_pattern != self.local_global_pattern - 1:
                    window = self.window
            mlp = "dense"
            if self.moe is not None and i % self.moe.every == self.moe.every - 1:
                mlp = "moe"
            specs.append(LayerSpec(mixer=mixer, mlp=mlp, window=window,
                                   cross_attn=self.encoder_layers > 0))
        return specs

    def scan_period(self) -> int:
        """Smallest repeating period of the layer pattern (for scan-stacking)."""
        specs = self.layer_specs()
        for p in range(1, len(specs) + 1):
            if len(specs) % p == 0 and all(
                    specs[i] == specs[i % p] for i in range(len(specs))):
                return p
        return len(specs)

    # --------------------------------------------------------- param math
    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if spec.mixer == "attn":
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            x_attn = (q + kv + o) if spec.cross_attn else 0
            return q + kv + o + bias + x_attn
        if spec.mixer == "mamba":
            di = self.mamba.d_inner(d)
            ds = self.mamba.d_state
            dtr = max(1, di // 16)
            return (d * 2 * di                 # in_proj
                    + self.mamba.d_conv * di + di   # conv
                    + di * (dtr + 2 * ds)      # x_dbc
                    + dtr * di + di            # dt_proj + bias
                    + di * ds + di             # A_log + D
                    + di * d)                  # out_proj
        if spec.mixer == "rwkv":
            r = self.rwkv
            lora = 5 * (d * r.mix_lora + r.mix_lora * d) + d * r.decay_lora \
                + r.decay_lora * d
            return 5 * d * d + lora + 9 * d    # r,k,v,g,o + mixes/decay/norm
        return 0

    def _mlp_params(self, spec: LayerSpec) -> Tuple[int, int]:
        """(total, active) parameters of the FFN of one layer."""
        d = self.d_model
        if spec.mixer == "rwkv":  # channel-mix: wu, wd, receptance gate
            n = 2 * d * self.d_ff + d * d + 2 * d
            return n, n
        if spec.mlp == "moe":
            m = self.moe
            nmat = 3 if self.glu else 2
            per = nmat * d * m.d_expert
            total = m.num_experts * per + d * m.num_experts  # + router
            active = m.top_k * per
            if m.shared_expert:
                shared = nmat * d * self.d_ff
                total += shared
                active += shared
            return total, active
        nmat = 3 if self.glu else 2
        per = nmat * d * self.d_ff
        return per, per

    def param_count(self) -> int:
        total = self.padded_vocab * self.d_model * (
            1 if self.tie_embeddings else 2)
        if self.pos == "learned":
            total += self.max_seq * self.d_model
        for spec in self.layer_specs():
            total += self._mixer_params(spec)
            total += self._mlp_params(spec)[0]
            total += 2 * self.d_model  # norms
        # encoder stack (uniform attention + dense mlp)
        enc_spec = LayerSpec(mixer="attn", mlp="dense")
        for _ in range(self.encoder_layers):
            total += self._mixer_params(enc_spec)
            total += self._mlp_params(enc_spec)[0]
            total += 2 * self.d_model
        return total

    def active_param_count(self) -> int:
        active = self.padded_vocab * self.d_model * (
            1 if self.tie_embeddings else 2)
        if self.pos == "learned":
            active += self.max_seq * self.d_model
        for spec in self.layer_specs():
            active += self._mixer_params(spec)
            active += self._mlp_params(spec)[1]
            active += 2 * self.d_model
        enc_spec = LayerSpec(mixer="attn", mlp="dense")
        for _ in range(self.encoder_layers):
            active += self._mixer_params(enc_spec)
            active += self._mlp_params(enc_spec)[1]
            active += 2 * self.d_model
        return active

    def model_flops(self, tokens: int) -> float:
        """MODEL_FLOPS = 6·N_active·D (the roofline 'useful compute' term)."""
        return 6.0 * self.active_param_count() * tokens

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = self.scan_period()
        n_layers = max(period, min(2 * period, 4))
        if self.n_layers % period:
            n_layers = period
        d_model = 64
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      d_expert=32)
        mamba = MambaCfg(d_state=4, d_conv=4, expand=2) if self.mamba else None
        rwkv = RWKVCfg(head_dim=16, decay_lora=8, mix_lora=8) if self.rwkv else None
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16, d_ff=128, vocab=256, max_seq=128,
            window=min(self.window, 16) if self.window else None,
            moe=moe, mamba=mamba, rwkv=rwkv,
            encoder_layers=2 if self.encoder_layers else 0,
            mrope_sections=(2, 3, 3), dtype="float32")
