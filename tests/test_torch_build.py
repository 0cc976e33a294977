"""The kernel build's host side (``kernels/_build.py``), which runs only on
the machine with nvcc: library naming, the source list, and the ptxas
report parser that ``chip_smoke.py`` prints from."""

import pytest

from vpt_tpu_torch.kernels import _build

LOG = """== mcm_spectral.cu
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__4976ea89_15_mcm_spectral_cu_9e01920911step_kernelILi12ELb1ELb0EEEvNS_6ParamsEPfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__4976ea89_15_mcm_spectral_cu_9e01920911step_kernelILi12ELb1ELb0EEEvNS_6ParamsEPfS2_
    40 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__4976ea89_15_mcm_spectral_cu_9e01920920sample_volume_kernelEPKviiiiPKfS3_S3_Pfi' for 'sm_90a'
ptxas info    : Used 28 registers, used 0 barriers
== spectral_backward.cu
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d619tape_forward_kernelILi32EEEvNS_6ParamsENS_8TapeSpecEPf' for 'sm_90a'
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d614reverse_kernelILi16EEEvNS_3RevEPKfS3_PfS4_PKiPKjS4_S4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d614reverse_kernelILi16EEEvNS_3RevEPKfS3_PfS4_PKiPKjS4_S4_S4_
    512 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 123 registers, used 1 barriers, 512 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d621surrogate_tape_kernelILi12ELb1EEEvNS_6ParamsENS_7SurSpecEPf' for 'sm_90a'
ptxas info    : Used 64 registers, used 0 barriers
== surrogate.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0EEEvNS_6ParamsENS_7SurSpecEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0EEEvNS_6ParamsENS_7SurSpecEPKf
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 32 bytes cumulative stack size
== corners.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0b1d2e3f_10_corners_cu_4f5e6d7c22contract_volume_kernelEPKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0b1d2e3f_10_corners_cu_4f5e6d7c22contract_volume_kernelEPKfPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
"""


def test_ptxas_table_reads_the_step_kernels_only():
    assert _build.ptxas_table(LOG) == [("step_kernel", "12,1,0", 48, 4, 8, 40),
                                       ("tape_forward_kernel", "32", 64, 0, 0, 32),
                                       ("reverse_kernel", "16", 123, 12, 16, 512),
                                       ("surrogate_tape_kernel", "12,1", 64, 0, 0, 0),
                                       ("surrogate_reverse_kernel", "12,0", 96, 0, 0, 32),
                                       ("contract_volume_kernel", "", 26, 0, 0, 0)]
    assert _build.ptxas_table("") == []


def test_library_names_separate_directories():
    src = _build.CSRC_DIR / "mcm_spectral.cu"
    plain = _build.library_path(src)
    assert plain == _build.library_path(src)  # named by content: stable
    assert plain.parent == _build.BUILD_DIR and plain.name.startswith("libvpt_mcm_spectral_")
    other = _build.library_path(_build.CSRC_DIR / "corners.cu")
    assert other.name.startswith("libvpt_corners_") and other != plain


def test_sources_of_each_directory():
    assert set(_build._sources()) == set(_build._SIGNATURES)
    assert set(_build._SIGNATURES) == {"mcm_spectral", "spectral_backward", "corners",
                                       "gather_bench", "surrogate", "raw_backward", "raymarch",
                                       "mcm", "mcs", "dos", "lao", "slab"}


RAYMARCH_LOG = """== raymarch.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5d1e2f3a_11_raymarch_cu_7c6b5a4912march_kernelILi1ELi0EEEvNS_5MarchEPKvPKfPfPKiS6_' for 'sm_90a'
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5d1e2f3a_11_raymarch_cu_7c6b5a4916iso_shade_kernelENS_5MarchEPKvPKfS4_S4_S4_S4_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__5d1e2f3a_11_raymarch_cu_7c6b5a4916iso_shade_kernelENS_5MarchEPKvPKfS4_S4_S4_S4_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5d1e2f3a_11_raymarch_cu_7c6b5a4910iso_kernelENS_5MarchEPKvPKfPfS5_S5_S5_' for 'sm_90a'
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__5d1e2f3a_11_raymarch_cu_7c6b5a4910mip_kernelILi7EEEvNS_5MarchEPKvPKfPf' for 'sm_90a'
ptxas info    : Used 48 registers, used 0 barriers
"""


def test_ptxas_table_reads_the_ray_march_kernels():
    """K15's kind (EAM 0, Depth 1) and table mode are its template
    arguments, K16's table mode its one; iso_kernel is not read into
    iso_shade_kernel's row."""
    assert _build.ptxas_table(RAYMARCH_LOG) == [("march_kernel", "1,0", 56, 0, 0, 0),
                                                ("iso_shade_kernel", "", 56, 0, 0, 0),
                                                ("iso_kernel", "", 40, 0, 0, 0),
                                                ("mip_kernel", "7", 48, 0, 0, 0)]


MCM_LOG = """== mcm.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c15mcm_step_kernelILi0EEEvNS_9McmParamsENS_8McmStateEPKvPKfS7_PKjS9_S9_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c15mcm_step_kernelILi0EEEvNS_9McmParamsENS_8McmStateEPKvPKfS7_PKjS9_S9_
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c15mcm_step_kernelILi7EEEvNS_9McmParamsENS_8McmStateEPKvPKfS7_PKjS9_S9_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c15mcm_step_kernelILi7EEEvNS_9McmParamsENS_8McmStateEPKvPKfS7_PKjS9_S9_
    56 bytes stack frame, 48 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c16mcm_reset_kernelENS_9McmParamsEjNS_8McmStateEPKjS4_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__6a7b8c9d_6_mcm_cu_1f2e3d4c16mcm_reset_kernelENS_9McmParamsEjNS_8McmStateEPKjS4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


def test_ptxas_table_reads_the_rgb_mcm_kernels():
    """K20 (csrc/mcm.cu) is an instance per table pair, mcm_step_kernel<MODE>
    (MODE the McmMode index): its rows carry it; K21 is untemplated, and
    K1's name inside K20's does not match."""
    assert _build.ptxas_table(MCM_LOG) == [("mcm_step_kernel", "0", 48, 0, 0, 32),
                                           ("mcm_step_kernel", "7", 48, 48, 28, 56),
                                           ("mcm_reset_kernel", "", 40, 0, 0, 0)]


MCS_LOG = """== mcs.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d17mcs_frames_kernelILi0ELb0EEEvNS_9McsParamsEPKvPKfS5_PK6float2PK6float4PS9_PKi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d17mcs_frames_kernelILi0ELb0EEEvNS_9McsParamsEPKvPKfS5_PK6float2PK6float4PS9_PKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d17mcs_frames_kernelILi5ELb1EEEvNS_9McsParamsEPKvPKfS5_PK6float2PK6float4PS9_PKi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d17mcs_frames_kernelILi5ELb1EEEvNS_9McsParamsEPKvPKfS5_PK6float2PK6float4PS9_PKi
    24 bytes stack frame, 24 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_mcs_kernel():
    """K22 (csrc/mcs.cu) is an instance per table mode and majorant,
    mcs_frames_kernel<MODE, MAJ>: its rows carry both (MODE the McsMode
    index, MAJ 0 or 1)."""
    assert _build.ptxas_table(MCS_LOG) == [("mcs_frames_kernel", "0,0", 64, 0, 0, 0),
                                           ("mcs_frames_kernel", "5,1", 64, 24, 36, 24)]


MCSP_LOG = """== mcs.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d21mcs_persistent_kernelILi0ELb0EEEvNS_9McsParamsEPKvPKfS5_PK6float2PKjNS_8McsLanesE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d21mcs_persistent_kernelILi0ELb0EEEvNS_9McsParamsEPKvPKfS5_PK6float2PKjNS_8McsLanesE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d21mcs_persistent_kernelILi5ELb1EEEvNS_9McsParamsEPKvPKfS5_PK6float2PKjNS_8McsLanesE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__7b8c9d0e_6_mcs_cu_2a3b4c5d21mcs_persistent_kernelILi5ELb1EEEvNS_9McsParamsEPKvPKfS5_PK6float2PKjNS_8McsLanesE
    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 40 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_mcs_persistent_kernel():
    """K23 (csrc/mcs.cu, beside K22) is an instance per table mode and
    majorant, mcs_persistent_kernel<MODE, MAJ>: its rows carry both (MODE
    the McsMode index, MAJ 0 or 1), and K22's name is not read inside them."""
    assert _build.ptxas_table(MCSP_LOG) == [("mcs_persistent_kernel", "0,0", 78, 0, 0, 32),
                                            ("mcs_persistent_kernel", "5,1", 80, 8, 8, 40)]
    assert "mcs_persistent_kernel" in _build.KERNELS


SURROGATE_XY_LOG = """== spectral_backward.cu
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d621surrogate_tape_kernelILi12ELb1ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPf' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d621surrogate_tape_kernelILi12ELb1ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPf
    40 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 40 bytes cumulative stack size
== surrogate.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0ELb1ELb1EEEvNS_6ParamsENS_7SurSpecEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0ELb1ELb1EEEvNS_6ParamsENS_7SurSpecEPKf
    64 bytes stack frame, 28 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 64 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_surrogate_xy_instantiations():
    """K4's surrogate mode and K12 carry <NB,MAJ,ENV,XY>: the xy flag is
    the fourth template argument of their rows."""
    assert _build.ptxas_table(SURROGATE_XY_LOG) == [
        ("surrogate_tape_kernel", "12,1,0,1", 64, 4, 4, 40),
        ("surrogate_reverse_kernel", "12,0,1,1", 80, 28, 36, 64)]


SURROGATE_RAW_LOG = """== spectral_backward.cu
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d621surrogate_tape_kernelILi12ELb1ELb0ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPf' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__329e020e_20_spectral_backward_cu_fefce9d621surrogate_tape_kernelILi12ELb1ELb0ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPf
    40 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 40 bytes cumulative stack size
== surrogate.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0ELb0ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1a2b3c4d_12_surrogate_cu_0a1b2c3d24surrogate_reverse_kernelILi12ELb0ELb0ELb0ELb1EEEvNS_6ParamsENS_7SurSpecEPKf
    120 bytes stack frame, 156 bytes spill stores, 136 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 120 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_surrogate_raw_instantiations():
    """K4's surrogate mode and K12 carry <NB,MAJ,ENV,XY,RAW>: the raw
    tables' flag is the fifth template argument of their rows."""
    assert _build.ptxas_table(SURROGATE_RAW_LOG) == [
        ("surrogate_tape_kernel", "12,1,0,0,1", 64, 4, 4, 40),
        ("surrogate_reverse_kernel", "12,0,0,0,1", 80, 156, 136, 120)]


OCCLUSION_LOG = """== dos.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__8c9d0e1f_6_dos_cu_3b4c5d6e16dos_slice_kernelENS_4DosPEfffPKvPKfPK6float2P6float4S5_PfSC_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__8c9d0e1f_6_dos_cu_3b4c5d6e16dos_slice_kernelENS_4DosPEfffPKvPKfPK6float2P6float4S5_PfSC_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__8c9d0e1f_6_dos_cu_3b4c5d6e18dos_display_kernelEiPK6float4Pf' for 'sm_90a'
ptxas info    : Used 16 registers, used 0 barriers
== lao.cu
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__9d0e1f2a_6_lao_cu_4c5d6e7f16lao_frame_kernelILb1ELb0ELi2EEEvNS_4LaoPEPKvPKfPK6float2Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__9d0e1f2a_6_lao_cu_4c5d6e7f16lao_frame_kernelILb1ELb0ELi2EEEvNS_4LaoPEPKvPKfPK6float2Pf
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 32 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_occlusion_kernels():
    """K24 (csrc/dos.cu) is untemplated; K25's row carries LAO,SHADOWS,MODE
    (MODE 2: the packed u8 table under the quasicubic filter)."""
    assert _build.ptxas_table(OCCLUSION_LOG) == [("dos_slice_kernel", "", 40, 0, 0, 0),
                                                 ("dos_display_kernel", "", 16, 0, 0, 0),
                                                 ("lao_frame_kernel", "1,0,2", 56, 0, 0, 32)]


SLAB_LOG = """== slab.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8016slab_rows_kernelEPKvillPKiP6float4l' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8016slab_rows_kernelEPKvillPKiP6float4l
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8019slab_advance_kernelILb1EEEvNS_6ParamsEPKfS3_S3_S3_S3_S3_PKjS5_jiPjPK6float2PiPfSB_SB_' for 'sm_90a'
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8018slab_finish_kernelILi12ELb0ELb1EEEvNS_6ParamsEPfS2_S2_S2_S2_S2_PiS3_S3_S2_S2_PKjS5_PjPK6float4PKfSB_SB_PKiSB_SB_' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8018slab_finish_kernelILi12ELb0ELb1EEEvNS_6ParamsEPfS2_S2_S2_S2_S2_PiS3_S3_S2_S2_PKjS5_PjPK6float4PKfSB_SB_PKiSB_SB_
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 24 bytes cumulative stack size
"""


def test_ptxas_table_reads_the_slab_kernels():
    """K26 (csrc/slab.cu) is untemplated, K27 carries MAJ and K28
    NB,MAJ,ENV."""
    assert _build.ptxas_table(SLAB_LOG) == [("slab_rows_kernel", "", 20, 0, 0, 0),
                                            ("slab_advance_kernel", "1", 40, 0, 0, 0),
                                            ("slab_finish_kernel", "12,0,1", 56, 0, 0, 24)]


SLAB_BWD_LOG = """== slab.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8018slab_finish_kernelILi12ELb0ELb1ELb1EEEvNS_6ParamsEPfS2_S2_S2_S2_S2_PiS3_S3_S2_S2_PKjS5_PjPK6float4PKfSB_SB_PKiSB_SB_NS_8TapeSpecES2_' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8018slab_finish_kernelILi12ELb0ELb1ELb1EEEvNS_6ParamsEPfS2_S2_S2_S2_S2_PiS3_S3_S2_S2_PKjS5_PjPK6float4PKfSB_SB_PKiSB_SB_NS_8TapeSpecES2_
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8019slab_scatter_kernelEPKflllPf' for 'sm_90a'
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8020slab_contract_kernelEPKfiiiiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8020slab_contract_kernelEPKfiiiiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1e2f3a4b_7_slab_cu_5d6e7f8016slab_pack_kernelEPKfiiiiiPf' for 'sm_90a'
ptxas info    : Used 30 registers, used 0 barriers
"""


def test_ptxas_table_reads_the_slab_backward_kernels():
    """K28's TAPE instantiation carries NB,MAJ,ENV,TAPE; K29 slab_scatter,
    K30 slab_contract and K31 slab_pack are untemplated, and none is read
    as K26's or K10's row."""
    assert _build.ptxas_table(SLAB_BWD_LOG) == [("slab_finish_kernel", "12,0,1,1", 64, 0, 0, 32),
                                                ("slab_scatter_kernel", "", 24, 0, 0, 0),
                                                ("slab_contract_kernel", "", 40, 0, 0, 0),
                                                ("slab_pack_kernel", "", 30, 0, 0, 0)]
    assert {"slab_scatter_kernel", "slab_contract_kernel", "slab_pack_kernel"} <= set(
        _build.KERNELS)


def _enum_count(text, enum):
    """The value of the last entry (the count) of ``enum`` in a source's
    text: entries counted from 0, an explicit ``= N`` resetting the count."""
    import re

    body = re.search(r"enum " + enum + r" \{(.*?)\};", text, re.S).group(1)
    value = -1
    for entry in re.sub(r"//[^\n]*", "", body).split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = re.fullmatch(r"\w+\s*=\s*(\d+)", entry)
        value = int(m.group(1)) if m else value + 1
    return value


@pytest.mark.parametrize("module,source,f_enum,i_enum", [
    ("dos", "dos.cu", "DosF", "DosI"), ("lao", "lao.cu", "LaoF", "LaoI"),
    ("raymarch", "raymarch.cu", "MarchF", "MarchI"), ("mcs", "mcs.cu", "McsF", "McsI"),
    ("mcm", "mcm.cu", "McmF", "McmI")])
def test_parameter_layouts_match_the_sources(module, source, f_enum, i_enum):
    """Each wrapper's parameter block counts (``_F_COUNT``, ``_I_COUNT``)
    equal its source's enums, which the library also reports at run time."""
    import importlib

    mod = importlib.import_module(f"vpt_tpu_torch.kernels.{module}")
    text = (_build.CSRC_DIR / source).read_text()
    assert (_enum_count(text, f_enum), _enum_count(text, i_enum)) == (mod._F_COUNT, mod._I_COUNT)


def test_backward_layouts_match_the_sources():
    """The packed backward's and the slab's wrappers against their sources:
    K5's integer block (``_R_COUNT``, RParam with R_ROUTED), the tape's
    fields (``TAPE_FIELDS``, TapeField, which K4 and K28's TAPE mode write),
    and K1's parameter block, which K27 and K28 take (FParam, IParam), as
    the libraries report them at run time (vpt_bwd_layout, vpt_slab_layout)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as SB

    bwd = (_build.CSRC_DIR / "spectral_backward.cu").read_text()
    common = (_build.CSRC_DIR / "adjoint_common.cuh").read_text()
    step = (_build.CSRC_DIR / "mcm_common.cuh").read_text()
    assert _enum_count(bwd, "RParam") == SB._R_COUNT
    assert "R_ROUTED" in bwd and "enum TapeField" not in bwd
    assert _enum_count(common, "TapeField") == len(SB.TAPE_FIELDS)
    # F_COUNT is 24 + MAX_BINS + 1 there, an expression _enum_count does not read
    assert "F_COUNT = 24 + MAX_BINS + 1," in step and K._F_COUNT == 24 + K.MAX_BINS + 1
    assert _enum_count(step, "IParam") == K._I_COUNT
    slab = (_build.CSRC_DIR / "slab.cu").read_text()
    assert '#include "adjoint_common.cuh"' in slab and "case 3: return T_COUNT;" in slab
