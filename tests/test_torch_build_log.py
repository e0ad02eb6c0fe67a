"""The build's ptxas report (``ops/_build.ptxas_usage``), which
``chip_smoke.py`` and the kernel sweeps read for each kernel's registers
and spill bytes, parsed from output in the form ``nvcc -Xptxas=-v``
prints."""

from gpy_dla_detection_tpu_torch.ops._build import NVCC_FLAGS, ptxas_usage

LOG = """== logmvn_chain_grad.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124logmvn_chain_grad_kernelILi24EEEvPKfS2_S2_iiiPfS3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124logmvn_chain_grad_kernelILi24EEEvPKfS2_S2_iiiPfS3_S3_
    32 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124logmvn_chain_grad_kernelILi64EEEvPKfS2_S2_iiiPfS3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124logmvn_chain_grad_kernelILi64EEEvPKfS2_S2_iiiPfS3_S3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_129logmvn_chain_grad_wide_kernelILb1EEEvPKfS2_S2_iiPfS3_S3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_129logmvn_chain_grad_wide_kernelILb1EEEvPKfS2_S2_iiPfS3_S3_S3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 408 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_matching_kernel():
    assert "-Xptxas=-v" in NVCC_FLAGS
    assert ptxas_usage(LOG, r"logmvn_chain_grad_kernelILi(\d+)E") == {
        ("24",): (64, 28), ("64",): (255, 0)}
    assert ptxas_usage(LOG, r"logmvn_chain_grad_wide_kernelILb(\d)E") == {("1",): (40, 0)}
    assert ptxas_usage(LOG, r"logmvn_chain_kernelILi(\d+)E") == {}
