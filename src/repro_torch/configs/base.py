"""Model configs: the port of ``repro.configs.base`` for the slice.

``ModelConfig`` keeps the reference's fields and defaults, so a config reads
the same in both packages; ``register`` / ``get_config`` keep the FULL and
SMOKE registries.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000

    # Layer layout: pattern = prefix + unit * n_units + suffix.
    prefix: tuple = ()
    unit: tuple = ("attn_global",)
    n_units: int = 2
    suffix: tuple = ()

    # Attention.
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # 0 = same as rope_theta (gemma3: 1e6)
    local_window: int = 4096
    attn_softcap: float = 0.0       # 0 = disabled
    final_softcap: float = 0.0
    qk_norm: bool = False

    # MLP.
    activation: str = "swiglu"      # swiglu | geglu | relu2 | gelu

    # MoE.
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_type: str = "softmax"    # softmax | sigmoid (dsv3 aux-free)

    # MLA (deepseek-v3).
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # Recurrent (RG-LRU / xLSTM).
    rnn_width: int = 0
    conv_width: int = 4
    mlstm_chunk: int = 64
    mlstm_state_dtype: str = "float32"

    # Encoder-decoder (seamless).
    is_encdec: bool = False
    n_enc_layers: int = 0

    # Modality frontend stubs.
    num_prefix_embeds: int = 0
    audio_frontend: bool = False

    # Misc.
    embed_scale: bool = False       # gemma sqrt(d_model) embedding scaling
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    post_norm: bool = False         # gemma-2/3 post-block norms
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    quadratic: bool = True

    def layer_pattern(self) -> tuple:
        pat = tuple(self.prefix) + tuple(self.unit) * self.n_units + tuple(self.suffix)
        if len(pat) != self.n_layers:
            raise ValueError(f"{self.name}: layout gives {len(pat)} layers != "
                             f"n_layers={self.n_layers}")
        return pat

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  triggers per-arch module imports
    return (_SMOKE_REGISTRY if smoke else _REGISTRY)[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
