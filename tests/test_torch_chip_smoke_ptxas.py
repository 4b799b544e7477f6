"""chip_smoke.py's gate on ptxas's report: the wide bf16 and the fp32 split-TF32
mainloops (``*_wide_kernel_sm90``, ``*_f32_sm90``, the fp32 wide form's
``*_wide_kernel_f32_sm90`` included) must spill nothing and
keep their wgmma unserialized (no warning C7512). The log is nvcc's
``-Xptxas -v`` output, in the form the card's toolkit prints it; the gate
runs there, this holds its parser to that form on the CPU."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

WIDE = "_ZN4anon26attn_bhnd_wide_kernel_sm90E14CUtensorMap_stS0_S0_S0_NS_4sm908WideArgsE"
F32 = "_ZN4anon28attn_batched_kernel_f32_sm90INS_7sm90f326ConfigILi64ELi64ELi3EEEEEvif"
K4 = "_ZN4anon4gemm16w8a8_kernel_sm90INS0_6ConfigILi128EEEEEvPKfiii"
WIDE_F32 = "_ZN4anon30attn_bhnd_wide_kernel_f32_sm90E14CUtensorMap_stS0_S0_S0_NS_7sm90f328WideArgsE"


def _entry(name, registers, stores=0, loads=0, stack=0):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 2 barriers\n")


def _serialized(name):
    return ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
            "instructions are serialized due to insufficient register resources "
            f"for the function '{name}'\n")


CLEAN = _entry(WIDE, 254) + _entry(F32, 123) + _entry(K4, 168, stack=16)


def test_ptxas_report_reads_registers_spills_and_serialization():
    report = chip_smoke.ptxas_report(CLEAN + _serialized(K4))
    assert report[WIDE] == {"registers": 254, "spill_stores": 0, "spill_loads": 0,
                            "serialized": False}
    assert report[F32]["registers"] == 123
    assert report[K4]["serialized"]
    assert chip_smoke.ptxas_faults(chip_smoke.ptxas_report(CLEAN)) == []


@pytest.mark.parametrize("log, culprit", [
    (_entry(WIDE, 255, stores=2264, loads=2264) + _entry(F32, 123), WIDE),
    (_entry(WIDE, 254) + _entry(F32, 168, loads=8), F32),
    (_serialized(WIDE) + CLEAN, WIDE),
    (CLEAN + _serialized(F32), F32),
    (_entry(WIDE, 254) + _entry(K4, 168), "_f32_sm90"),
    (CLEAN + _entry(WIDE_F32, 224, stores=64, loads=64), WIDE_F32),
], ids=["wide-spills", "f32-spill-loads", "wide-serialized", "f32-serialized",
        "f32-missing", "f32-wide-spills"])
def test_ptxas_gate_refuses_spills_serialization_and_missing_kernels(log, culprit):
    faults = chip_smoke.ptxas_faults(chip_smoke.ptxas_report(log))
    assert len(faults) == 1 and culprit in faults[0]
