"""unigeo_tpu_torch/tools/kernel_report.py's readers of ptxas's and
cuobjdump's text, on excerpts in their formats (the tool itself needs nvcc
and runs on the machine with the card: tests/test_torch_cuda.py)."""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import pytest

from unigeo_tpu_torch.tools.kernel_report import ffma_share, ptxas_info, sass_counts, template_args

F32REG = "_ZN12_GLOBAL__N_126flash_packed_f32reg_kernelILi4ELi2ELi2EEEvPKfS2_S2_Pf"
WGMMA = "_ZN12_GLOBAL__N_126flash_packed_wgmma_kernelILi64EEEv14CUtensorMap_st"

PTXAS = f"""ptxas info    : Compiling entry function '{F32REG}' for 'sm_90a'
ptxas info    : Function properties for {F32REG}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 210 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '{WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {WGMMA}
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, 384 bytes cmem[0]
"""

SASS = f"""	code for sm_90a
		Function : {F32REG}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
        /*0010*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R6.64], P1 ;
        /*0020*/                   LDS.128 R4, [R2+0x10] ;
        /*0030*/               @P0 FFMA R8, R4, R5, R8 ;
        /*0040*/                   FFMA R9, R4, R5, R9 ;
        /*0050*/                   MUFU.EX2 R10, R10 ;
        /*0060*/                   SHFL.BFLY PT, R11, R10, 0x1, 0x1f ;
        /*0070*/                   STS.128 [R12], R8 ;
        /*0080*/                   LDS R13, [R12] ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
		Function : {WGMMA}
        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0010*/                   STL [R1], R2 ;
"""


def test_ptxas_info_reads_registers_and_spills_per_kernel():
    info = ptxas_info(PTXAS)
    assert info[F32REG] == {"spill_stores": 0, "spill_loads": 0, "registers": 210}
    assert info[WGMMA] == {"spill_stores": 12, "spill_loads": 4, "registers": 168}


def test_sass_counts_the_f32_body_instructions():
    counts = sass_counts(SASS, "f32reg")
    assert list(counts) == [F32REG]
    assert counts[F32REG] == {"LDGSTS": 1, "LDS": 2, "LDS.128": 1, "FFMA": 2, "MUFU": 1,
                              "MUFU.EX2": 1, "SHFL": 1, "STS": 1, "STS.128": 1, "BAR": 1,
                              "total": 10}


@pytest.mark.parametrize("match,expected", [("wgmma", {"tensor_core": 1, "STL": 1, "total": 2}),
                                            ("no_such_kernel", None)])
def test_sass_counts_tensor_core_ops_and_spills_per_match(match, expected):
    counts = sass_counts(SASS, match)
    assert counts == ({} if expected is None else {WGMMA: expected})


def test_template_args_of_a_mangled_name():
    assert template_args(F32REG) == [4, 2, 2]
    assert template_args(WGMMA) == [64]


def test_ffma_share_of_the_static_sass():
    """FFMA over every instruction: 2 of the f32 body's 10 above; a kernel
    with no instruction has none."""
    counts = sass_counts(SASS, "f32reg")
    assert ffma_share(counts[F32REG]) == pytest.approx(0.2)
    assert ffma_share(sass_counts(SASS, "wgmma")[WGMMA]) == 0.0
    assert ffma_share({}) is None


def test_sass_counts_the_tma_bulk_copies():
    """The f32 body at d = 512 copies its rows with the TMA's bulk copies
    (UBLKCP), which the report counts as a family of their own."""
    name = "_ZN12_GLOBAL__N_127flash_packed_f32w512_kernelILi16EEEvPKfS2_S2_PfS3_l"
    sass = f"""		Function : {name}
        /*0000*/                   UBLKCP.S.G [UR8], [UR6], UR10 ;
        /*0010*/                   FFMA R9, R4, R5, R9 ;
"""
    assert sass_counts(sass, "f32w512") == {name: {"UBLKCP": 1, "FFMA": 1, "total": 2}}
