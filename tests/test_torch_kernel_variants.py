"""Which kernel variant each wrapper picks, on the CPU.

``gather_matmul.variant(dtype, m, q)`` and ``flash_attention.variant(dtype,
hd)`` decide from the dtype and the shape alone (never by trying a
launch): ``"wgmma"`` for the bf16 widths TMA can load, ``"mma"`` for the
other bf16 shapes, ``"fma"`` for f32. The models' main-path shapes must
take ``"wgmma"``; a call on CPU tensors runs the plain version and counts
no launch in any variant. The variants' codes are the C interface's.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import gather_matmul as gmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, gather_matmul_ref

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,hd,want", [
    (F32, 16, "fma"), (F32, 64, "fma"), (F32, 128, "fma"),
    (BF16, 16, "mma"), (BF16, 64, "wgmma"), (BF16, 128, "wgmma")])
def test_flash_variant(dtype, hd, want):
    assert fmod.variant(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd", [(BF16, 96), (F32, 32), (BF16, 256),
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


@pytest.mark.parametrize("mod", [fmod, gmod], ids=["flash", "gather"])
def test_variant_codes_match_the_kernel(mod):
    """``VARIANTS[i]`` is the code ``i`` that the C launch function reads
    (``enum Variant`` in its source)."""
    name = "flash_attention" if mod is fmod else "gather_matmul"
    src = (build.CSRC / f"{name}.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {k.strip().lower(): int(v) for k, v in
             (e.split("=") for e in enum.split(","))}
    assert codes == {v: i for i, v in enumerate(mod.VARIANTS)}


@pytest.mark.parametrize("dtype,hd", [(F32, 16), (F32, 128), (BF16, 16),
                                      (BF16, 64), (BF16, 128)])
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
        "gather_matmul": dict.fromkeys(gmod.VARIANTS, 0),
        "flash_attention": dict.fromkeys(fmod.VARIANTS, 0)}
    torch.testing.assert_close(out, gather_matmul_ref(x, g, idx, bk=32))


def test_reset_zeroes_every_variant(monkeypatch):
    for mod in (fmod, gmod):
        monkeypatch.setattr(mod, "launches", 3)
        for var in mod.VARIANTS:
            mod.launches_by_variant[var] = 1
    ops.reset_launch_counts()
    for mod in (fmod, gmod):
        assert mod.launches == 0
        assert mod.launches_by_variant == dict.fromkeys(mod.VARIANTS, 0)
