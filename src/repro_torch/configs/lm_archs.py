"""The 10 assigned architectures (a copy of ``repro.configs.lm_archs``).

Each entry is a builder returning an LMConfig; ``smoke_config`` shrinks any
of them to a CPU-runnable reduced config of the same family (same pattern,
same feature set — tiny dims) for the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm.config import LMConfig, MLAConfig, MoEConfig


def xlstm_125m() -> LMConfig:
    # [ssm] 12L d768 4H d_ff=0 vocab 50304 — sLSTM + mLSTM [arXiv:2405.04517]
    return LMConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv=4, d_ff=0, vocab=50304,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlp="none", mlstm_heads=4, slstm_heads=4, conv_width=4,
        tie_embeddings=True, sub_quadratic=True)


def recurrentgemma_9b() -> LMConfig:
    # [hybrid] 38L d4096 16H kv=1 d_ff 12288 vocab 256000 — RG-LRU + local 1:2
    return LMConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
        head_dim=256,
        pattern=("rglru", "rglru", "local"), n_repeats=12,
        suffix=("rglru", "rglru"),
        local_window=2048, mlp="geglu", lru_width=4096, conv_width=4,
        tie_embeddings=True, sub_quadratic=True)


def llama32_vision_11b() -> LMConfig:
    # [vlm] 40L d4096 32H kv=8 d_ff 14336 vocab 128256 — cross-attn layers
    return LMConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40,
        d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
        pattern=("attn", "attn", "attn", "attn", "cross"),
        rope_theta=500000.0, mlp="swiglu", cross_seq=6404)


def qwen3_1_7b() -> LMConfig:
    # [dense] 28L d2048 16H kv=8 d_ff 6144 vocab 151936 — qk_norm, GQA
    return LMConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv=8, d_ff=6144, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, mlp="swiglu", tie_embeddings=True)


def qwen2_0_5b() -> LMConfig:
    # [dense] 24L d896 14H kv=2 d_ff 4864 vocab 151936 — GQA, QKV bias
    return LMConfig(
        name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv=2, d_ff=4864, vocab=151936, head_dim=64,
        qkv_bias=True, rope_theta=1e6, mlp="swiglu", tie_embeddings=True)


def qwen3_32b() -> LMConfig:
    # [dense] 64L d5120 64H kv=8 d_ff 25600 vocab 151936 — qk_norm, GQA
    return LMConfig(
        name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=64, n_kv=8, d_ff=25600, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, mlp="swiglu")


def internlm2_20b() -> LMConfig:
    # [dense] 48L d6144 48H kv=8 d_ff 16384 vocab 92544 — GQA
    return LMConfig(
        name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
        n_heads=48, n_kv=8, d_ff=16384, vocab=92544, head_dim=128,
        rope_theta=1e6, mlp="swiglu")


def deepseek_v2_lite_16b() -> LMConfig:
    # [moe] 27L d2048 16H d_ff 1408 vocab 102400, 64e top-6, 2 shared, MLA 512
    return LMConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27,
        d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
        prefix=("attn",), pattern=("attn_moe",), n_repeats=26,
        mlp="swiglu", rope_theta=10000.0,
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                      d_ff_dense=10944, first_dense=1),
        mla=MLAConfig(kv_lora=512, q_lora=None, qk_nope=128, qk_rope=64,
                      v_head=128))


def deepseek_v2_236b() -> LMConfig:
    # [moe] 60L d5120 128H d_ff 1536 vocab 102400, 160e top-6, 2 shared, MLA
    return LMConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60,
        d_model=5120, n_heads=128, n_kv=128, d_ff=1536, vocab=102400,
        prefix=("attn",), pattern=("attn_moe",), n_repeats=59,
        mlp="swiglu", rope_theta=10000.0,
        moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536,
                      d_ff_dense=12288, first_dense=1),
        mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64,
                      v_head=128))


def musicgen_medium() -> LMConfig:
    # [audio] 48L d1536 24H kv=24 d_ff 6144 vocab 2048 — EnCodec-token decoder
    return LMConfig(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv=24, d_ff=6144, vocab=2048,
        mlp="gelu", norm="layernorm", embeds_input=True)


ARCHS = {
    "xlstm-125m": xlstm_125m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen2-0.5b": qwen2_0_5b,
    "qwen3-32b": qwen3_32b,
    "internlm2-20b": internlm2_20b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "musicgen-medium": musicgen_medium,
}


def get_arch(name: str) -> LMConfig:
    cfg = ARCHS[name]()
    cfg.validate()
    return cfg


def smoke_config(name: str) -> LMConfig:
    """Reduced same-family config: tiny dims, same pattern/features."""
    cfg = get_arch(name)
    hd = 16
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_model = 64
    repl: dict = dict(
        name=cfg.name + "-smoke",
        d_model=d_model, head_dim=hd, n_heads=n_heads, n_kv=n_kv,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab=512, cross_seq=24 if cfg.cross_seq else 0,
        lru_width=d_model if cfg.lru_width else None,
        local_window=16, attn_chunk=32,
        n_layers=(len(cfg.prefix) + len(cfg.pattern) * 2 + len(cfg.suffix)),
        n_repeats=2,
    )
    if cfg.moe is not None:
        # capacity_factor=8 ⇒ dropless at smoke scale (deterministic tests)
        repl["moe"] = MoEConfig(n_routed=8, n_shared=1, top_k=2,
                                d_expert=32, d_ff_dense=96, first_dense=1,
                                capacity_factor=8.0)
        repl["d_ff"] = 32
    if cfg.mla is not None:
        repl["mla"] = MLAConfig(kv_lora=32, q_lora=(48 if cfg.mla.q_lora
                                                    else None),
                                qk_nope=16, qk_rope=8, v_head=16)
    out = dataclasses.replace(cfg, **repl)
    out.validate()
    return out
