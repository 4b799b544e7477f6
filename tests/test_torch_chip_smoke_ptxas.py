"""chip_smoke.py's gate on ptxas's report: the wide bf16 and the fp32 kernels
(``*_wide_kernel_sm90``, ``*_f32_sm90``: the split-TF32 mainloop, the fp32
wide form's ``*_wide_kernel_f32_sm90`` and the fp32 K4's
``w8a8_kernel_f32_sm90`` included) must spill nothing and
keep their wgmma unserialized (no warning C7512). The log is nvcc's
``-Xptxas -v`` output, in the form the card's toolkit prints it; the gate
runs there, this holds its parser to that form on the CPU. Beside it, the
gate on ``cuobjdump -sass``'s counts: every kernel of the library is an
entry of ``SM90_KERNELS`` with its wgmma and TMA instructions."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

WIDE = "_ZN4anon26attn_bhnd_wide_kernel_sm90E14CUtensorMap_stS0_S0_S0_NS_4sm908WideArgsE"
F32 = "_ZN4anon28attn_batched_kernel_f32_sm90INS_7sm90f326ConfigILi64ELi64ELi3EEEEEvif"
K4 = "_ZN4anon4gemm16w8a8_kernel_sm90INS0_6ConfigI13__nv_bfloat16Li128EEEEEv14CUtensorMap_stS5_PKfS7_S7_PS3_iii"
K4_F32 = "_ZN4anon4gemm20w8a8_kernel_f32_sm90INS0_6ConfigIfLi128EEEEEv14CUtensorMap_stS4_S4_PKfS6_S6_Pfiiii"
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
    (CLEAN + _entry(K4_F32, 168, stores=32, loads=32), K4_F32),
    (CLEAN + _entry(K4_F32, 168) + _serialized(K4_F32), K4_F32),
], ids=["wide-spills", "f32-spill-loads", "wide-serialized", "f32-serialized",
        "f32-missing", "f32-wide-spills", "k4-f32-spills", "k4-f32-serialized"])
def test_ptxas_gate_refuses_spills_serialization_and_missing_kernels(log, culprit):
    faults = chip_smoke.ptxas_faults(chip_smoke.ptxas_report(log))
    assert len(faults) == 1 and culprit in faults[0]


def _sass_clean():
    """A count per instantiation of every SM90_KERNELS entry, as a clean
    library's ``cuobjdump -sass`` gives them."""
    counts = {}
    for entry, (count, mma) in chip_smoke.SM90_KERNELS.items():
        for i in range(count):
            counts[f"_ZN4anon{entry}ILi{i}EEEvv"] = {
                "HGMMA": 0, "IGMMA": 0, "UTMALDG": 3,
                "UTMASTG": 4 if entry in chip_smoke.TMA_STORE_KERNELS else 0, mma: 8}
    return counts


def test_sass_gate_takes_a_library_of_sm90_kernels():
    assert chip_smoke.sass_faults(_sass_clean()) == []


@pytest.mark.parametrize("cut, culprit", [
    ("outside", "_ZN4anon15w8a8_kernel_f32ILb1EEEvv"),
    ("no-tma-store", "w8a8_kernel_f32_sm90"),
    ("no-igmma", "w8a8_kernel_f32_sm90"),
    ("missing", "w8a8_kernel_f32_sm90"),
    ("a-third-bf16-width", "w8a8_kernel_sm90"),
])
def test_sass_gate_refuses_a_kernel_off_wgmma_or_tma(cut, culprit):
    """A kernel outside SM90_KERNELS (the wmma loop K4 ran in fp32 before),
    an fp32 K4 without TMA stores, without int8 wgmma, or missing, and an
    instantiation more than the entry names."""
    counts = _sass_clean()
    (f32,) = [f for f in counts if "w8a8_kernel_f32_sm90" in f]
    if cut == "outside":
        counts[culprit] = {"HGMMA": 0, "IGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
    elif cut == "no-tma-store":
        counts[f32]["UTMASTG"] = 0
    elif cut == "no-igmma":
        counts[f32]["IGMMA"] = 0
    elif cut == "missing":
        del counts[f32]
    else:
        counts["_ZN4anonw8a8_kernel_sm90ILi9EEEvv"] = {"HGMMA": 0, "IGMMA": 8, "UTMALDG": 3,
                                                        "UTMASTG": 0}
    faults = chip_smoke.sass_faults(counts)
    assert len(faults) == 1 and culprit in faults[0]
