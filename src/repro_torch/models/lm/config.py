"""LMConfig: one decoder config covering the assigned architectures.

A copy of ``repro.models.lm.config`` (framework-free dataclasses), kept
here so the port imports nothing of the reference.

Layer heterogeneity is expressed as ``prefix + pattern×n_repeats + suffix``
(layer-kind strings). The reference scans the ``pattern`` super-block; the
port keeps one module per layer.

Layer kinds:
  attn       — causal GQA self-attention (+dense MLP per cfg.mlp)
  attn_moe   — causal self-attention + MoE FFN (DeepSeek layers ≥ first_dense)
  local      — sliding-window causal attention (+MLP)
  cross      — gated cross-attention to modality states (+MLP)
  rglru      — Griffin RG-LRU recurrent block (+MLP)
  mlstm      — xLSTM matrix-memory block (self-contained projections)
  slstm      — xLSTM scalar-memory block (sequential scan)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int          # per-expert FFN width (d_ff in the assignment)
    d_ff_dense: int        # FFN width of the first dense layer(s)
    first_dense: int = 1
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int | None = None   # None = direct q projection (V2-Lite)
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # layer plan
    prefix: tuple[str, ...] = ()
    pattern: tuple[str, ...] = ("attn",)
    n_repeats: int | None = None        # default: fill n_layers
    suffix: tuple[str, ...] = ()
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 2048
    # mlp flavor
    mlp: str = "swiglu"                 # swiglu | geglu | gelu | none
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    # extensions
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    cross_seq: int = 0                  # modality KV length (vlm stub)
    lru_width: int | None = None        # rglru state width
    conv_width: int = 4
    mlstm_heads: int = 4
    slstm_heads: int = 4
    # embeddings / numerics
    tie_embeddings: bool = False
    embeds_input: bool = False          # audio/vlm stub feeds embeddings
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # training-memory knobs (per-cell overridable)
    remat: bool = True
    attn_chunk: int = 1024              # flash kv-chunk length
    sub_quadratic: bool = False         # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def repeats(self) -> int:
        if self.n_repeats is not None:
            return self.n_repeats
        body = self.n_layers - len(self.prefix) - len(self.suffix)
        assert body % len(self.pattern) == 0, \
            f"{self.name}: {body} layers not divisible by pattern " \
            f"{self.pattern}"
        return body // len(self.pattern)

    def layer_plan(self) -> list[str]:
        return (list(self.prefix) + list(self.pattern) * self.repeats
                + list(self.suffix))

    def validate(self) -> None:
        assert len(self.layer_plan()) == self.n_layers, \
            (self.name, len(self.layer_plan()), self.n_layers)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_plan():
            total += _layer_params(self, kind)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k counting)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_plan():
            total += _layer_params(self, kind, active_only=True)
        return total


def _attn_params(cfg: LMConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    if cfg.mla is not None:
        m = cfg.mla
        q_in = m.q_lora if m.q_lora else d
        n = d * m.kv_lora + d * m.qk_rope                       # kv down + k_rope
        n += q_in * cfg.n_heads * (m.qk_nope + m.qk_rope)       # q up
        if m.q_lora:
            n += d * m.q_lora
        n += m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_head)   # k/v up
        n += cfg.n_heads * m.v_head * d                         # out
        return n
    return d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d


def _mlp_params(cfg: LMConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _layer_params(cfg: LMConfig, kind: str, active_only: bool = False) -> int:
    d = cfg.d_model
    if kind == "attn":
        return _attn_params(cfg) + \
            (_mlp_params(cfg, cfg.d_ff) if cfg.mlp != "none" else 0)
    if kind == "attn_moe":
        m = cfg.moe
        n_ff = (m.n_shared + (m.top_k if active_only else m.n_routed))
        return (_attn_params(cfg) + n_ff * _mlp_params(cfg, m.d_expert)
                + d * m.n_routed)
    if kind == "local":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "cross":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "rglru":
        w = cfg.lru_width or d
        return 2 * d * w + w * d + 3 * w + cfg.conv_width * w \
            + _mlp_params(cfg, cfg.d_ff)
    if kind == "mlstm":
        up = 2 * d
        return 2 * d * up + up * d + 3 * up + 4 * up * up // cfg.mlstm_heads
    if kind == "slstm":
        h = d
        return 4 * d * h + 4 * h * h // cfg.slstm_heads + \
            _mlp_params(cfg, int(d * 4 / 3))
    raise ValueError(kind)
