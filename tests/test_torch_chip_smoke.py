"""``chip_smoke.py``'s zero-spill gate reads ptxas's report of every K1 instance.

K1 is a template (a 128- and a 256-wide instance), so the gate must see
each instance's spill line, and fail when the kernel is not in the report
at all (a build whose log was lost would otherwise pass unchecked).
"""

from __future__ import annotations

import pytest

import chip_smoke

LOG = """\
ptxas info    : Compiling entry function '_Z7k3_convv' for 'sm_90a'
ptxas info    : Function properties for _Z7k3_convv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii
    32 bytes stack frame, 32 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""


def test_ptxas_spills_reads_every_instance():
    got = chip_smoke.ptxas_spills(LOG, "meta_kernel_fused_wgmma")
    assert got == {
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii": 0,
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii": 80,
    }


def test_ptxas_spills_fails_without_the_kernel():
    with pytest.raises(RuntimeError, match="not in the ptxas log"):
        chip_smoke.ptxas_spills("", "meta_kernel_fused_wgmma")
