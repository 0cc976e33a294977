"""The kernel build's host side (``kernels/_build.py``), which runs only on
the machine with nvcc: library naming, the source list, and the ptxas
report parser that ``chip_smoke.py`` prints from."""

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
                                       "gather_bench", "surrogate", "raw_backward"}
