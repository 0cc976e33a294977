"""The kernel build's host side (``kernels/_build.py``), which runs only on
the machine with nvcc: library naming, the ptxas report parser that
``chip_smoke.py`` prints from, and the routing of the wrappers to the
parent design's build."""

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
"""


def test_ptxas_table_reads_the_step_kernels_only():
    assert _build.ptxas_table(LOG) == [("step_kernel", "12,1,0", 48, 4, 8),
                                       ("tape_forward_kernel", "32", 64, 0, 0)]
    assert _build.ptxas_table("") == []


def test_library_names_separate_directories():
    src = _build.CSRC_DIR / "mcm_spectral.cu"
    plain = _build.library_path(src)
    assert plain == _build.library_path(src)  # named by content: stable
    assert plain.parent == _build.BUILD_DIR and plain.name.startswith("libvpt_mcm_spectral_")
    base = _build.library_path(_build.BASELINE_DIR / "mcm_spectral.cu")
    assert base.name.startswith("libvpt_baseline_mcm_spectral_") and base != plain


def test_sources_of_each_directory():
    assert set(_build._sources(_build.CSRC_DIR)) == set(_build._SIGNATURES)
    # the parent design's directory holds the two step sources only
    assert set(_build._sources(_build.BASELINE_DIR)) == {"mcm_spectral", "spectral_backward"}


def test_routed_restores_load_even_on_error():
    load, lib = _build.load, object()
    with pytest.raises(RuntimeError):
        with _build.routed(lib):
            assert _build.load() is lib and _build.load(_build.BASELINE_DIR) is lib
            raise RuntimeError
    assert _build.load is load

