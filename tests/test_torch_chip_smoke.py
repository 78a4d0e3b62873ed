"""The parts of ``chip_smoke.py`` that run without a card: reading the
forward kernels' build facts from nvcc's ``-Xptxas -v`` report."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2ca4sm9010fwd_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii' for 'sm_90a'
ptxas info    : Function properties for _ZN2ca4sm9010fwd_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN2ca4sm9010fwd_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii' for 'sm_90a'
ptxas info    : Function properties for _ZN2ca4sm9010fwd_kernelILi256ELb0ELb1EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfNS_5ShapeEii
    16 bytes stack frame, 12 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN2ca9dq_kernelILi256ELb1ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 236 registers, used 1 barriers
"""


@pytest.mark.parametrize("flags,want", [
    ("ELb1ELb0E", {"registers": 168, "spill_store_bytes": 0,
                   "spill_load_bytes": 0}),
    ("ELb0ELb1E", {"registers": 168, "spill_store_bytes": 12,
                   "spill_load_bytes": 32}),
])
def test_ptxas_facts_reads_each_kernels_own_block(flags, want):
    """Each instantiation's registers and spills come from its own block
    of the report, not from the kernel compiled after it."""
    key = f"sm9010fwd_kernelILi256{flags}"
    assert chip_smoke.ptxas_facts(_LOG, key) == want


def test_ptxas_facts_raises_for_a_kernel_not_in_the_report():
    with pytest.raises(AssertionError, match="no ptxas report"):
        chip_smoke.ptxas_facts(_LOG, "sm9010fwd_kernelILi128ELb1ELb0E")
