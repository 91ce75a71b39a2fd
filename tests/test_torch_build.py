"""The kernel build's cache key, on the CPU (nothing is compiled).

``build.library_path`` names a library by a hash of its ``.cu`` source,
every shared header ``csrc/*.cuh`` and the ``nvcc`` flags, so an edit to
any of them (``hopper.cuh`` included) builds a new library instead of
loading a stale one.
"""
import re

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private ``csrc`` with one kernel source and one header."""
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "hopper.cuh"\nint k;\n')
    (d / "hopper.cuh").write_text("// version 1\n")
    monkeypatch.setattr(build, "CSRC", d)
    return d


@pytest.mark.parametrize("edit", ["header", "new_header", "source",
                                  "removed_header"])
def test_an_edit_changes_library_path(csrc, edit):
    before = build.library_path("k")
    if edit == "header":
        (csrc / "hopper.cuh").write_text("// version 2\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("// more\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "hopper.cuh"\nint k2;\n')
    elif edit == "removed_header":
        (csrc / "hopper.cuh").unlink()
    assert build.library_path("k") != before


def test_flags_change_library_path(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != before


def test_unchanged_tree_keeps_library_path(csrc, tmp_path):
    """Same bytes, same name: an up-to-date library is loaded as it is.
    Files that are not headers do not count."""
    first = build.library_path("k")
    (csrc / "notes.txt").write_text("not a header\n")
    assert build.library_path("k") == first
    assert first.parent == build.BUILD_DIR
    assert re.fullmatch(r"libk-[0-9a-f]{16}\.so", first.name)


@pytest.mark.parametrize("name", ["gather_matmul", "flash_attention",
                                  "bcoo_spmm"])
def test_redesigned_kernels_include_the_shared_header(name):
    """The redesigned kernels take their pieces from ``csrc/hopper.cuh``
    (TMA, mbarriers and wgmma for the two wgmma kernels; the launch with
    dynamic shared memory for ``bcoo_spmm``), so its edits must rebuild
    them."""
    assert (build.CSRC / "hopper.cuh").is_file()
    assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    assert build.library_path(name).name.startswith(f"lib{name}-")


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module (its main()
    is not run)."""
    import importlib.util
    path = build.CSRC.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ptxas -v lines as nvcc prints them for sm_90a: a hash digit of the
# anonymous namespace runs into the kernel name's length prefix ("...a7"
# + "13flash_fwd_f32").
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea72wg15flash_fwd_wgmmaILi128EEEv14CUtensorMap_stS2_S2_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea72wg15flash_fwd_wgmmaILi128EEEv14CUtensorMap_stS2_S2_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea713flash_fwd_f32ILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__7da9e1b5_16_gather_matmul_cu_06c1a0ee14gather_mm_bf16ENS_6ParamsE' for 'sm_90a'
ptxas info    : Used 98 registers, used 1 barriers, 20480 bytes smem
"""


def test_ptxas_summary_names_each_kernel():
    summary = _chip_smoke().ptxas_summary(PTXAS_LOG)
    assert summary == {
        "flash_fwd_wgmma<128>": "0 bytes stack frame, 0 bytes spill "
                                "stores, 0 bytes spill loads; Used 168 "
                                "registers, used 1 barriers",
        "flash_fwd_f32<128>": "Used 80 registers, used 1 barriers",
        "gather_mm_bf16": "Used 98 registers, used 1 barriers, 20480 bytes "
                          "smem"}


# The bcoo_spmm library's kernels: templates over a type and integer or
# bool values (one name of each kind).
PTXAS_BCOO = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c23ed0de_12_bcoo_spmm_cu_d69f30194simt8spmm_fmaI13__nv_bfloat16EEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c23ed0de_12_bcoo_spmm_cu_d69f30192tc7spmm_tcIfLi128ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Used 208 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c23ed0de_12_bcoo_spmm_cu_d69f30192tc7spmm_tcIfLi64ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c23ed0de_12_bcoo_spmm_cu_d69f30192tc13reduce_chunksIfEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_summary_names_template_arguments():
    """Each instantiation keeps its own line: types by name, values as
    numbers (a bool as 0 or 1)."""
    summary = _chip_smoke().ptxas_summary(PTXAS_BCOO)
    assert summary == {
        "spmm_fma<bfloat16>": "Used 96 registers, used 1 barriers",
        "spmm_tc<float,128,1>": "Used 208 registers, used 1 barriers",
        "spmm_tc<float,64,0>": "Used 128 registers, used 1 barriers",
        "reduce_chunks<float>": "Used 32 registers, used 0 barriers"}
