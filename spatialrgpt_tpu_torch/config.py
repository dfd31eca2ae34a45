"""Composite model configuration.

Mirrors the reference's composite ``LlavaConfig`` contract
(llava/model/configuration_llava.py:4-59): one top-level config holding
per-module sub-configs (llm / vision tower / mm projector / region extractor)
plus the multimodal wiring flags.  All configs are frozen dataclasses, so
they hash.

The port's own copy of ``spatialrgpt_tpu/config.py``: the same presets and
fields, so that a preset name builds equal configs in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP ViT configuration (google/siglip-so400m-patch14-384 defaults)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    # Feature selection contract (reference vision_encoder.py:21-34):
    # select_layer indexes HF hidden_states (embeddings + one entry per layer);
    # -2 == output of layer (num_hidden_layers - 1).  select_feature
    # 'cls_patch' keeps all tokens, 'patch' drops token 0.
    select_layer: int = -2
    select_feature: str = "cls_patch"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder configuration for the Llama family and its relatives
    (Mistral = sliding window; Gemma = gelu MLP + (1+w) norms + scaled
    embeddings + tied head; Mixtral = Mistral + MoE).  Field meanings are
    HF-compatible so checkpoints convert mechanically."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # Linear RoPE scaling factor (reference language_model/builder.py:31-38):
    # applied when model_max_length > max_position_embeddings.
    rope_scaling_factor: Optional[float] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 128009
    # family knobs
    hidden_act: str = "silu"  # silu (llama/mistral) | gelu_tanh (gemma)
    sliding_window: Optional[int] = None  # mistral/mixtral
    norm_plus_one: bool = False  # gemma RMSNorm uses (1 + weight)
    scale_embeddings: bool = False  # gemma multiplies embeds by sqrt(hidden)
    explicit_head_dim: Optional[int] = None  # gemma fixes head_dim=256
    # MoE (mixtral); experts run densely like the reference
    # (modeling_mixtral_long_context.py top-2 routing executed densely)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    # "dense" mirrors the reference; "sparse" routes top-k tokens through
    # a grouped GEMM (lax.ragged_dot) at top_k/E of the dense FLOPs
    # (models/llama.py::_moe_block_sparse; requires stacked expert params)
    moe_impl: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.explicit_head_dim or self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


# Named decoder presets for the model families the reference ships
# (SURVEY.md S2.4).
LLAMA_PRESETS = {
    # princeton-nlp/Sheared-LLaMA-2.7B
    "sheared-3b": LlamaConfig(
        vocab_size=32000,
        hidden_size=2560,
        intermediate_size=6912,
        num_hidden_layers=32,
        num_attention_heads=20,
        num_key_value_heads=20,
        max_position_embeddings=4096,
        rope_theta=10000.0,
        eos_token_id=2,
    ),
    "llama2-7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        max_position_embeddings=4096,
        rope_theta=10000.0,
        eos_token_id=2,
    ),
    "mistral-7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=32768,
        rope_theta=10000.0,
        sliding_window=4096,
        eos_token_id=2,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=32768,
        rope_theta=1e6,
        sliding_window=None,
        num_experts=8,
        num_experts_per_tok=2,
        eos_token_id=2,
    ),
    "gemma-7b": LlamaConfig(
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=16,
        max_position_embeddings=8192,
        rope_theta=10000.0,
        hidden_act="gelu_tanh",
        norm_plus_one=True,
        scale_embeddings=True,
        explicit_head_dim=256,
        tie_word_embeddings=True,
        rms_norm_eps=1e-6,
        bos_token_id=2,
        eos_token_id=1,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=8192,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        bos_token_id=128000,
        eos_token_id=128009,
    ),
}


@dataclass(frozen=True)
class ProjectorConfig:
    """Multimodal projector (reference base_projector.py:63-94)."""

    projector_type: str = "mlp_downsample"  # identity|linear|mlp_downsample|mlpNx_gelu
    mm_hidden_size: int = 1152
    hidden_size: int = 4096


@dataclass(frozen=True)
class RegionExtractorConfig:
    """Region extractor (reference base_extractor.py:104-177)."""

    extractor_type: str = "regiongpt"
    mm_hidden_size: int = 1152
    hidden_size: int = 4096
    # deconvNx: (N-1) x [ConvT(k2,s2) + LayerNorm2d + GELU] + ConvT + GELU
    deconv_depth: int = 2
    # AdaptiveAvgPool2d target for the global (low-res) branch.
    ada_pool_size: int = 27
    mask_threshold: float = 0.5


@dataclass(frozen=True)
class SpatialRGPTConfig:
    """Composite VLM config: llm + vision tower + projector + region extractor."""

    llm: LlamaConfig = field(default_factory=lambda: LLAMA_PRESETS["llama3-8b"])
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    region: RegionExtractorConfig = field(default_factory=RegionExtractorConfig)

    enable_region: bool = True
    enable_depth: bool = True
    # Token ids of <mask> / <depth> in the extended tokenizer vocabulary.
    # The reference records these into the vision-tower config at load time
    # (model/builder.py:186-192); here they are first-class fields.
    mask_token_id: int = -1
    depth_token_id: int = -1

    image_aspect_ratio: str = "resize"  # resize | pad
    model_max_length: int = 4096
    # Extra embedding rows appended past llm.vocab_size for <mask>/<depth>.
    num_extra_tokens: int = 0

    def replace(self, **kw) -> "SpatialRGPTConfig":
        return dataclasses.replace(self, **kw)

    @property
    def extended_vocab_size(self) -> int:
        return self.llm.vocab_size + self.num_extra_tokens

    @property
    def tokens_per_image(self) -> int:
        """Spliced LLM tokens per image, derived from the projector's input
        grid (reference computes this implicitly from the projector output
        shape).  With regions enabled the projector consumes the ada-pooled
        ``lres`` grid (llava_arch.py:403,411 — AdaptiveAvgPool2d(27), so 27
        regardless of tower resolution); otherwise the raw tower grid.  The
        mlp_downsample projector then folds 2x2 patch blocks, padding odd
        grids (base_projector.py:32-53)."""
        side = (
            self.region.ada_pool_size
            if self.enable_region
            else self.vision.num_patches_per_side
        )
        if self.projector.projector_type == "mlp_downsample":
            return ((side + 1) // 2) ** 2
        return side * side

    # ---- serialization -------------------------------------------------
    def to_json(self) -> str:
        d = _asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SpatialRGPTConfig":
        d = json.loads(text)
        return cls(
            llm=LlamaConfig(**d["llm"]),
            vision=SiglipVisionConfig(**d["vision"]),
            projector=ProjectorConfig(**d["projector"]),
            region=RegionExtractorConfig(**d["region"]),
            **{
                k: v
                for k, v in d.items()
                if k not in ("llm", "vision", "projector", "region")
            },
        )

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "SpatialRGPTConfig":
        with open(os.path.join(path, "config.json")) as f:
            d = json.loads(f.read())
        if "llm_cfg" in d:  # reference LlavaConfig schema
            return from_reference_composite(path)
        return cls.from_json(json.dumps(d))


def preset(name: str, **overrides) -> SpatialRGPTConfig:
    """Build a composite config for a named model family."""
    llm = LLAMA_PRESETS[name]
    cfg = SpatialRGPTConfig(
        llm=llm,
        projector=ProjectorConfig(hidden_size=llm.hidden_size),
        region=RegionExtractorConfig(hidden_size=llm.hidden_size),
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def from_reference_composite(root: str) -> SpatialRGPTConfig:
    """Build a SpatialRGPTConfig from a reference-layout checkpoint
    directory: top-level LlavaConfig JSON (configuration_llava.py:4-59)
    with HF sub-configs under ``llm/ vision_tower/ mm_projector/
    region_extractor/`` (the layout llava/model/builder.py:142-159 +
    llava_arch.py resume from).  This is the loader real released
    SpatialRGPT checkpoints go through."""

    def sub(name):
        p = os.path.join(root, name, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    with open(os.path.join(root, "config.json")) as f:
        top = json.load(f)
    llm_d = sub("llm")
    vis_d = sub("vision_tower")
    proj_d = sub("mm_projector")
    reg_d = sub("region_extractor")

    rope_scaling = llm_d.get("rope_scaling") or {}
    llm = LlamaConfig(
        vocab_size=llm_d.get("vocab_size", 32000),
        hidden_size=llm_d.get("hidden_size", 4096),
        intermediate_size=llm_d.get("intermediate_size", 11008),
        num_hidden_layers=llm_d.get("num_hidden_layers", 32),
        num_attention_heads=llm_d.get("num_attention_heads", 32),
        num_key_value_heads=llm_d.get(
            "num_key_value_heads", llm_d.get("num_attention_heads", 32)
        ),
        max_position_embeddings=llm_d.get("max_position_embeddings", 4096),
        rms_norm_eps=llm_d.get("rms_norm_eps", 1e-5),
        rope_theta=llm_d.get("rope_theta", 10000.0),
        rope_scaling_factor=rope_scaling.get("factor"),
        tie_word_embeddings=llm_d.get("tie_word_embeddings", False),
        attention_bias=llm_d.get("attention_bias", False),
        bos_token_id=llm_d.get("bos_token_id", 1),
        eos_token_id=llm_d.get("eos_token_id", 2),
        hidden_act=llm_d.get("hidden_act", "silu"),
        sliding_window=llm_d.get("sliding_window"),
    )
    vision = SiglipVisionConfig(
        hidden_size=vis_d.get("hidden_size", 1152),
        intermediate_size=vis_d.get("intermediate_size", 4304),
        num_hidden_layers=vis_d.get("num_hidden_layers", 27),
        num_attention_heads=vis_d.get("num_attention_heads", 16),
        image_size=vis_d.get("image_size", 384),
        patch_size=vis_d.get("patch_size", 14),
        layer_norm_eps=vis_d.get("layer_norm_eps", 1e-6),
        select_layer=top.get("mm_vision_select_layer", -2),
        select_feature=top.get("mm_vision_select_feature", "cls_patch"),
    )
    mm_hidden = top.get("mm_hidden_size") or vision.hidden_size
    hidden = top.get("hidden_size") or llm.hidden_size
    projector = ProjectorConfig(
        projector_type=proj_d.get("mm_projector_type", "mlp_downsample"),
        mm_hidden_size=mm_hidden,
        hidden_size=hidden,
    )
    region = RegionExtractorConfig(mm_hidden_size=mm_hidden, hidden_size=hidden)
    mask_id = vis_d.get("llm_mask_token_id", -1)
    depth_id = vis_d.get("llm_depth_token_id", -1)
    extra = 0
    if mask_id >= llm.vocab_size or depth_id >= llm.vocab_size:
        extra = max(mask_id, depth_id) + 1 - llm.vocab_size
    return SpatialRGPTConfig(
        llm=llm,
        vision=vision,
        projector=projector,
        region=region,
        enable_region=top.get("enable_region", True),
        enable_depth=top.get("enable_depth", True),
        mask_token_id=mask_id,
        depth_token_id=depth_id,
        image_aspect_ratio=top.get("image_aspect_ratio") or "resize",
        model_max_length=top.get("model_max_length") or 4096,
        num_extra_tokens=extra,
    )
