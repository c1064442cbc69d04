"""The kernel build module's readers of the compiler's output: kernel names
from mangled symbols (integer, boolean and type template arguments) and
the registers, spills and stack frames of each kernel from a ``ptxas -v``
log, as chip_smoke.py's phase 2 prints and checks them.  No compiler is
needed."""

import pytest

from sciml_pde_torch.ops import _build


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_113fwd_tc_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiif",
     "fwd_tc_kernel<64>"),
    ("_ZN12_GLOBAL__N_115dkv_wide_kernelI13__nv_bfloat16EEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiif",
     "dkv_wide_kernel<__nv_bfloat16>"),
    ("_Z11wdft_kernelI13__nv_bfloat16Lb1EEvPKfS2_PfiiiPKT_iS3_ii",
     "wdft_kernel<__nv_bfloat16, true>"),
    ("_Z11wdft_kernelIfLb0EEvPKfS1_PfiiiPKT_iS2_ii", "wdft_kernel<float, false>"),
    ("_Z18reduce_rows_kernelPKfPfii", "reduce_rows_kernel"),
    ("_Z9not_a_knlPKf", "_Z9not_a_knlPKf"),
])
def test_kernel_name_reads_template_arguments(mangled, name):
    assert _build._kernel_name(mangled) == name


_LOG = (
    "ptxas info    : Compiling entry function '_Z18reduce_rows_kernelPKfPfii' for 'sm_90a'\n"
    "ptxas info    : Function properties for _Z18reduce_rows_kernelPKfPfii\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 32 registers, 384 bytes smem\n"
    "ptxas info    : Compiling entry function "
    "'_Z11wdft_kernelIfLb1EEvPKfS1_PfiiiPKT_iS2_ii' for 'sm_90a'\n"
    "ptxas info    : Function properties for _Z11wdft_kernelIfLb1EEvPKfS1_PfiiiPKT_iS2_ii\n"
    "    24 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads\n"
    "ptxas info    : Used 255 registers\n")


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    (tmp_path / "libfno_bwd-0.log").write_text(_LOG)
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}-0.so")
    assert _build.ptxas_report("fno_bwd") == [("reduce_rows_kernel", 32, 0, 0, 0),
                                              ("wdft_kernel<float, true>", 255, 16, 12, 24)]


def test_ptxas_report_reads_stack_frames(tmp_path, monkeypatch):
    """Each row ends with the kernel's stack frame (bytes), which phase 2
    requires to be 0 for the head kernels, read after the kernel's name."""
    (tmp_path / "libfno_bwd-0.log").write_text(
        _LOG + "ptxas info    : Compiling entry function "
        "'_Z15head_bwd_kernelILb1EEvPKfS1_S1_S1_S1_S1_PfS2_iiiiiiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_Z15head_bwd_kernelILb1EEvPKfS1_S1_S1_S1_S1_PfS2_iiiiiiii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, 384 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}-0.so")
    assert _build.ptxas_report("fno_bwd") == [
        ("reduce_rows_kernel", 32, 0, 0, 0), ("wdft_kernel<float, true>", 255, 16, 12, 24),
        ("head_bwd_kernel<true>", 96, 0, 0, 0)]


_SASS = """
\tcode for sm_90a
\t\tFunction : _Z16mix_wgrad_kernelI13__nv_bfloat16Li4ELi4EEvPKT_S3_PKfS5_PfS6_iiii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64] ;  /* 0x0000000402047981 */
        /*0020*/              @!P0 LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;  /* 0x0000000406087981 */
        /*0030*/                   IMAD.WIDE R12, R0, 0x4, R12 ;         /* 0x0000000400000000 */
        /*0040*/                   FMUL R14, R8, R4 ;                    /* 0x0000000408000000 */
        /*0050*/                   FADD R15, R14, R9 ;                   /* 0x0000000408000000 */
        /*0060*/                   STG.E.128 desc[UR4][R12.64], R14 ;   /* 0x0000000408000000 */
        /*0070*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _Z18reduce_rows_kernelPKfPfii
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;          /* 0x0000000402027981 */
        /*0010*/                   FFMA R3, R2, R2, RZ ;                 /* 0x0000000402037981 */
        /*0020*/                   LDG.E R4, desc[UR4][R6.64] ;          /* 0x0000000402027981 */
        /*0030*/                   STG.E desc[UR4][R8.64], R3 ;         /* 0x0000000402027981 */
"""


def test_sass_reader_orders_loads_arithmetic_and_stores():
    """``parse_sass`` splits ``cuobjdump -sass`` output by kernel (names as
    ``ptxas_report`` gives them, predicated instructions included) and
    ``memory_order`` gives the runs of global loads, f32 arithmetic and
    global stores that chip_smoke.py's phase 2 reads for mix_wgrad_kernel."""
    kernels = _build.parse_sass(_SASS)
    assert list(kernels) == ["mix_wgrad_kernel<__nv_bfloat16, 4, 4>", "reduce_rows_kernel"]
    assert len(kernels["mix_wgrad_kernel<__nv_bfloat16, 4, 4>"]) == 8
    assert _build.memory_order(kernels["mix_wgrad_kernel<__nv_bfloat16, 4, 4>"]) == "L2 F2 S1"
    assert _build.memory_order(kernels["reduce_rows_kernel"]) == "L1 F1 L1 S1"
