"""Language-model configurations and the architecture registry. A copy of
``repro/configs/base.py`` (``ModelConfig``, its layer pattern, analytic
parameter count and reduced smoke variant, and the registry), without the
dry-run input shapes, which the port does not use.

Each ported architecture lives in its own ``configs/<id>.py`` and
registers a full-size :class:`ModelConfig`; ``ModelConfig.reduced()`` is
its smoke variant.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


# ---------------------------------------------------------------------------
# Block kinds used by the layer-pattern machinery (hybrid archs).
# ---------------------------------------------------------------------------
ATTN = "attn"          # full (or sliding-window) self-attention + MLP
MAMBA = "mamba"        # mamba selective-scan block
MLSTM = "mlstm"        # xLSTM matrix-memory block (parallelizable)
SLSTM = "slstm"        # xLSTM scalar-memory block (recurrent)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None       # expert FFN width (defaults to d_ff)
    moe_layer_period: int = 1            # MoE every k-th layer (1 = all)
    moe_layer_offset: int = 0            # first MoE layer index mod period
    first_k_dense: int = 0               # deepseek: first k layers always dense
    router_aux_loss_coef: float = 0.01
    moe_groups: int = 1                  # GShard token groups (= data shards on mesh)
    moe_capacity_factor: float = 1.25    # expert capacity (tokens dropped beyond)

    # --- MLA (DeepSeek-V2) ---
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 = dense q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- hybrid / SSM ---
    attn_layer_period: int = 1           # jamba: 1 attention layer per 8
    attn_layer_offset: int = 0
    ssm_type: str = "none"               # none | mamba | xlstm
    d_state: int = 16
    conv_kernel: int = 4
    mamba_expand: int = 2
    slstm_period: int = 0                # xlstm: 1 sLSTM per k blocks (0 = none)
    slstm_offset: int = 7

    # --- encoder-decoder / multimodal frontends (stubs) ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    num_encoder_positions: int = 1500    # whisper audio frames after conv stub
    num_vision_patches: int = 0          # pixtral/llama4 patch embeddings prepended

    # --- attention details ---
    window: Optional[int] = None         # sliding-window width (None = full)
    qkv_bias: bool = False               # qwen2
    gated_mlp: bool = True               # SwiGLU (False: plain GELU MLP, whisper)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- numerics ---
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"     # bf16 for >=200B models

    # --- source citation ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def block_kind(self, layer_idx: int) -> str:
        """Which block type occupies layer ``layer_idx``."""
        if self.ssm_type == "xlstm":
            if self.slstm_period and layer_idx % self.slstm_period == self.slstm_offset:
                return SLSTM
            return MLSTM
        if self.ssm_type == "mamba":
            if layer_idx % self.attn_layer_period == self.attn_layer_offset:
                return ATTN
            return MAMBA
        return ATTN

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe or layer_idx < self.first_k_dense:
            return False
        return layer_idx % self.moe_layer_period == self.moe_layer_offset

    def layer_pattern(self) -> tuple:
        """(block_kind, is_moe) per layer — the structural signature.

        Scan-over-layers stacks parameters for layers sharing a signature.
        """
        return tuple((self.block_kind(i), self.is_moe_layer(i)) for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        if self.is_encoder_decoder:
            total += self.num_encoder_positions * d      # encoder pos embed (stub side)

        def attn_params() -> int:
            if self.mla:
                qdim = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                p = d * qdim if not self.q_lora_rank else d * self.q_lora_rank + self.q_lora_rank * qdim
                p += d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.num_heads * self.v_head_dim * d
                return p
            return d * n_q + 2 * d * n_kv + n_q * d

        def mlp_params(ff: int) -> int:
            return (3 if self.gated_mlp else 2) * d * ff  # (gate,) up, down

        def mamba_params() -> int:
            dinner = self.mamba_expand * d
            p = d * 2 * dinner                           # in_proj (x, z)
            p += dinner * self.conv_kernel               # depthwise conv
            p += dinner * (self.d_state * 2 + 1)         # B, C, dt per channel-ish
            p += dinner * self.d_state                   # A
            p += dinner * d                              # out_proj
            return p

        def xlstm_params(kind: str) -> int:
            dinner = 2 * d
            p = d * 2 * dinner + dinner * d              # up (x,z) + down
            p += 3 * dinner * (1 if kind == MLSTM else dinner // max(self.num_heads, 1))
            if kind == MLSTM:
                p += 3 * dinner * self.resolved_head_dim  # qkv-ish small projections
            return p

        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind == ATTN:
                total += attn_params()
                if self.is_moe_layer(i):
                    total += self.num_experts * mlp_params(self.resolved_moe_d_ff)
                    total += self.num_shared_experts * mlp_params(self.resolved_moe_d_ff)
                    total += d * self.num_experts        # router
                elif self.d_ff:
                    total += mlp_params(self.d_ff)
            elif kind == MAMBA:
                total += mamba_params()
                if self.is_moe_layer(i):
                    total += self.num_experts * mlp_params(self.resolved_moe_d_ff)
                    total += self.num_shared_experts * mlp_params(self.resolved_moe_d_ff)
                    total += d * self.num_experts
                elif self.d_ff:
                    total += mlp_params(self.d_ff)
            else:
                total += xlstm_params(kind)
            total += 2 * d                               # norms
        if self.is_encoder_decoder:
            # encoder blocks: self-attn + mlp
            total += self.encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            # decoder cross-attention
            total += self.num_layers * (attn_params() + d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = dataclasses.replace(
            self,
            num_experts=self.experts_per_token,
            num_shared_experts=self.num_shared_experts,
        )
        return full.param_count()

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 layers, small dims, <=4 experts."""
        def rd(v, cap):
            return min(v, cap) if v else v
        base = dict(
            name=self.name + "-smoke",
            num_layers=2 if self.ssm_type != "mamba" else max(2, self.attn_layer_period),
            d_model=rd(self.d_model, 256),
            num_heads=rd(self.num_heads, 4),
            num_kv_heads=rd(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=rd(self.d_ff, 512),
            vocab_size=rd(self.vocab_size, 512),
            num_experts=rd(self.num_experts, 4),
            experts_per_token=rd(self.experts_per_token, 2),
            num_shared_experts=rd(self.num_shared_experts, 1),
            moe_d_ff=rd(self.resolved_moe_d_ff, 256) if self.moe else None,
            kv_lora_rank=rd(self.kv_lora_rank, 64),
            q_lora_rank=rd(self.q_lora_rank, 64),
            qk_nope_dim=rd(self.qk_nope_dim, 32),
            qk_rope_dim=rd(self.qk_rope_dim, 16),
            v_head_dim=rd(self.v_head_dim, 32),
            encoder_layers=rd(self.encoder_layers, 2),
            num_encoder_positions=rd(self.num_encoder_positions, 32),
            num_vision_patches=rd(self.num_vision_patches, 16),
            window=rd(self.window, 64) if self.window else None,
            slstm_offset=1 if self.slstm_period else self.slstm_offset,
            slstm_period=2 if self.slstm_period else 0,
            attn_layer_offset=0,
        )
        if self.ssm_type == "mamba":
            base["attn_layer_period"] = 2
            base["num_layers"] = 2
        base.update(overrides)
        return dataclasses.replace(self, **base)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)
