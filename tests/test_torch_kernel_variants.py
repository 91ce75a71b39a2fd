"""Which kernel variant each wrapper picks, on the CPU.

``gather_matmul.variant(dtype, m, q)`` and ``flash_attention.variant(dtype,
hd)`` decide from the dtype and the shape alone (never by trying a
launch): ``"wgmma"`` for the bf16 widths TMA can load, ``"mma"`` for the
other bf16 shapes, ``"fma"`` for f32. ``bcoo_spmm.variant(dtype, bm, bk,
d)`` picks ``"tf32x3"`` (f32) or ``"mma"`` (bf16) for bk a multiple of 8
and ``"fma"`` otherwise, and ``bcoo_spmm.chunks`` how far its tensor-core
variants split each row block's segment. The models' main-path shapes must
take a tensor-core variant; a call on CPU tensors runs the plain version
and counts no launch in any variant. The variants' codes are the C
interface's.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import bcoo_spmm as kmod
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import gather_matmul as gmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bcoo_spmm_ref, flash_attention_ref, \
    gather_matmul_ref

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,hd,want", [
    (F32, 16, "fma"), (F32, 64, "fma"), (F32, 128, "fma"), (F32, 256, "fma"),
    (BF16, 16, "mma"), (BF16, 64, "wgmma"), (BF16, 128, "wgmma"),
    (BF16, 256, "wgmma_hd256")])
def test_flash_variant(dtype, hd, want):
    assert fmod.variant(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd", [(BF16, 96), (F32, 32), (BF16, 192),
                                      (torch.float16, 128)])
def test_flash_variant_refuses(dtype, hd):
    with pytest.raises(ValueError):
        fmod.variant(dtype, hd)


@pytest.mark.parametrize("dtype,m,q,want", [
    (F32, 2048, 6144, "fma"), (F32, 41, 96, "fma"),
    (BF16, 2048, 6144, "wgmma"), (BF16, 6144, 2048, "wgmma"),
    (BF16, 200, 264, "wgmma"), (BF16, 8, 8, "wgmma"),
    (BF16, 41, 96, "mma"), (BF16, 96, 41, "mma"), (BF16, 130, 264, "mma"),
    (BF16, 1, 1, "mma")])
def test_gather_variant(dtype, m, q, want):
    assert gmod.variant(dtype, m, q) == want


def test_gather_variant_refuses_other_dtypes():
    with pytest.raises(ValueError):
        gmod.variant(torch.float16, 64, 64)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-0.5b"])
def test_main_path_shapes_take_wgmma(arch):
    """The bf16 prefill's attention and both sampled dW products of the
    MLP (gate/up: d_model x d_ff, down: d_ff x d_model)."""
    cfg = get_arch(arch)
    assert cfg.dtype == "bfloat16"
    assert fmod.variant(BF16, cfg.hd) == "wgmma"
    assert gmod.variant(BF16, cfg.d_model, cfg.d_ff) == "wgmma"
    assert gmod.variant(BF16, cfg.d_ff, cfg.d_model) == "wgmma"


@pytest.mark.parametrize("arch,flash", [
    ("recurrentgemma-9b", "wgmma_hd256"), ("llama-3.2-vision-11b", "wgmma"),
    ("musicgen-medium", "wgmma"), ("deepseek-v2-lite-16b", None),
    ("deepseek-v2-236b", None), ("xlstm-125m", None)])
def test_family_shapes_take_tensor_core_variants(arch, flash):
    """The other families' bf16 prefill attention (MLA's runs no kernel,
    xLSTM has no attention) and the sampled dW products of their dense
    MLPs (a MoE model's dense layer is ``d_ff_dense`` wide)."""
    cfg = get_arch(arch)
    if flash is not None:
        assert fmod.variant(BF16, cfg.hd) == flash
    if cfg.mlp != "none":
        d_ff = cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff
        assert gmod.variant(BF16, cfg.d_model, d_ff) == "wgmma"
        assert gmod.variant(BF16, d_ff, cfg.d_model) == "wgmma"


@pytest.mark.parametrize("dtype,bm,bk,d,want", [
    (F32, 128, 128, 256, "tf32x3"), (F32, 128, 128, 41, "tf32x3"),
    (F32, 8, 8, 602, "tf32x3"), (F32, 32, 16, 72, "tf32x3"),
    (F32, 1, 24, 1, "tf32x3"), (F32, 16, 12, 41, "fma"),
    (F32, 128, 4, 256, "fma"), (BF16, 128, 128, 256, "mma"),
    (BF16, 8, 8, 41, "mma"), (BF16, 64, 64, 602, "mma"),
    (BF16, 32, 20, 256, "fma"), (BF16, 128, 1, 1, "fma")])
def test_bcoo_variant(dtype, bm, bk, d, want):
    assert kmod.variant(dtype, bm, bk, d) == want


@pytest.mark.parametrize("dtype,bm,bk,d", [
    (torch.float16, 128, 128, 256), (F32, 129, 128, 256), (F32, 0, 8, 8),
    (BF16, 128, 0, 8), (F32, 128, 128, 0)])
def test_bcoo_variant_refuses(dtype, bm, bk, d):
    with pytest.raises(ValueError):
        kmod.variant(dtype, bm, bk, d)


@pytest.mark.parametrize("d", [256, 41])
def test_gcn_main_path_shapes_take_tf32x3(d):
    """The serving GCN's f32 layers (block 128, hidden 256, 41 classes),
    the column tile the dispatcher gives them, and the chunk counts on an
    H100's 132 SMs for the heaviest partition at ``--scale 0.1`` (62 row
    blocks, s_pad 10,878): at most one wave of the card's CTA slots."""
    assert kmod.variant(F32, 128, 128, d) == "tf32x3"
    bd = ops.resolve_bd(None, d)
    assert bd == d
    n = kmod.chunks(62, 10878, d, bd, 132)
    assert n == {256: 1, 41: 4}[d]
    assert 62 * kmod.column_tiles(d, bd) * n <= 132 * (2 if d <= 64 else 1)


@pytest.mark.parametrize("n_rb,s_pad,d,bd,n_sm,want", [
    (62, 10878, 256, 256, 132, 1),    # the heaviest partition, d = 256
    (62, 10878, 41, 41, 132, 4),      # and at the 41 classes
    (62, 10878, 256, 128, 132, 1),    # a narrower dispatched column tile
    (62, 10878, 256, 64, 132, 1),     # 4 x 62 CTAs of 64 columns fill it
    (62, 115, 256, 256, 132, 1),      # a sampled backward plan: 1-4 tiles
    (62, 115, 41, 41, 132, 1),
    (4, 367, 256, 256, 132, 11),      # few row blocks, one of 320 tiles
    (4, 367, 41, 41, 132, 11),
    (3, 1531, 256, 256, 132, 22),     # a 1,500-entry run of padding
    (5000, 600000, 256, 256, 132, 1),  # the row blocks alone fill it
    (62, 10878, 602, 602, 132, 1),    # 5 column tiles of 128
    (62, 10878, 256, 256, 16, 1),     # a small card
    (1, 8, 41, 41, 132, 1),
    (0, 0, 41, 41, 132, 1)])
def test_bcoo_chunks(n_rb, s_pad, d, bd, n_sm, want):
    assert kmod.chunks(n_rb, s_pad, d, bd, n_sm) == want


@pytest.mark.parametrize("d,bd,want", [(256, 256, 2), (41, 41, 1),
                                       (602, 602, 5), (72, 8, 9),
                                       (256, 64, 4), (72, 72, 1)])
def test_bcoo_column_tiles(d, bd, want):
    assert kmod.column_tiles(d, bd) == want


@pytest.mark.parametrize("mod", [fmod, gmod, kmod],
                         ids=["flash", "gather", "bcoo"])
def test_variant_codes_match_the_kernel(mod):
    """``VARIANTS[i]`` is the code ``i`` that the C launch function reads
    (``enum Variant`` in its source)."""
    name = {fmod: "flash_attention", gmod: "gather_matmul",
            kmod: "bcoo_spmm"}[mod]
    src = (build.CSRC / f"{name}.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {k.strip().lower(): int(v) for k, v in
             (e.split("=") for e in enum.split(","))}
    assert codes == {v: i for i, v in enumerate(mod.VARIANTS)}


@pytest.mark.parametrize("dtype,hd", [(F32, 16), (F32, 128), (BF16, 16),
                                      (BF16, 64), (BF16, 128), (F32, 256),
                                      (BF16, 256)])
def test_flash_cpu_call_counts_no_launch(dtype, hd):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((1, 9, 4, hd), (1, 9, 2, hd),
                                    (1, 9, 2, hd)))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=5)
    assert fmod.launches == 0
    assert set(fmod.launches_by_variant.values()) == {0}
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, causal=True,
                                                        window=5))


@pytest.mark.parametrize("dtype,m,q", [(F32, 16, 24), (BF16, 16, 24),
                                       (BF16, 7, 9)])
def test_gather_cpu_call_counts_no_launch(dtype, m, q):
    rng = np.random.default_rng(m + q)
    x, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((96, m), (96, q)))
    idx = torch.tensor([0, 2], dtype=torch.int32)
    ops.reset_launch_counts()
    out = ops.gather_matmul(x, g, idx, bk=32)
    assert gmod.launches == 0
    assert set(gmod.launches_by_variant.values()) == {0}
    assert ops.launch_counts_by_variant() == {
        "bcoo_spmm": dict.fromkeys(kmod.VARIANTS, 0),
        "gather_matmul": dict.fromkeys(gmod.VARIANTS, 0),
        "flash_attention": dict.fromkeys(fmod.VARIANTS, 0)}
    torch.testing.assert_close(out, gather_matmul_ref(x, g, idx, bk=32))


@pytest.mark.parametrize("dtype,bm,bk,d", [(F32, 16, 16, 41), (F32, 8, 12, 9),
                                           (BF16, 16, 16, 24),
                                           (BF16, 8, 8, 5)])
def test_bcoo_cpu_call_counts_no_launch(dtype, bm, bk, d):
    rng = np.random.default_rng(bm + bk + d)
    blocks = torch.from_numpy(rng.standard_normal((4, bm, bk)).astype(
        np.float32)).to(dtype)
    blocks[3] = 0
    h = torch.from_numpy(rng.standard_normal((3 * bk, d)).astype(
        np.float32)).to(dtype)
    sel, rows, cols = (torch.tensor(x, dtype=torch.int32) for x in
                       ([0, 1, 3, 2, 3], [0, 0, 0, 2, 2], [0, 2, 0, 1, 0]))
    kw = dict(n_row_blocks=3, bm=bm, bk=bk, relu=True)
    ops.reset_launch_counts()
    out = ops.bcoo_spmm(blocks, sel, rows, cols, h, **kw)
    assert kmod.launches == 0
    assert ops.launch_counts_by_variant()["bcoo_spmm"] == \
        dict.fromkeys(kmod.VARIANTS, 0)
    torch.testing.assert_close(out, bcoo_spmm_ref(blocks, sel, rows, cols, h,
                                                  **kw))


def test_reset_zeroes_every_variant(monkeypatch):
    for mod in (fmod, gmod, kmod):
        monkeypatch.setattr(mod, "launches", 3)
        for var in mod.VARIANTS:
            mod.launches_by_variant[var] = 1
    ops.reset_launch_counts()
    for mod in (fmod, gmod, kmod):
        assert mod.launches == 0
        assert mod.launches_by_variant == dict.fromkeys(mod.VARIANTS, 0)
