"""``tools/k2_leap_probe.py`` on the CPU: its probe kernel's source against
the landing header, its SASS reading, its kernel matching, its checkout
paths and its plain run.  Its times, builds and disassembly need a card and
nvcc; there it runs as ``python3 -m pikazoo_tpu_torch.tools.k2_leap_probe``."""

import shutil
import subprocess

import pytest

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.tools import k2_leap_probe

# A host stand-in for what the probe kernel uses of CUDA.
CUDA_SHIM = """
#include <cstdint>
#define __global__
struct Dim { int32_t x; };
static Dim blockIdx, blockDim, threadIdx;
"""

SASS = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z8one_jumpILb1EEvPiii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
                                                                               /* 0x000fe40000000800 */
        /*0010*/                   I2FP.F32.S32 R3, R2 ;                       /* 0x0000000200037245 */
        /*0020*/                   MUFU.RSQ R4, R3 ;                           /* 0x0000000300047308 */
        /*0030*/                   IMAD.HI.U32 R5, R2, R6, RZ ;                /* 0x0000000602057227 */
        /*0040*/                   VOTE.ALL P0, P1 ;                           /* 0x0000000000007806 */
        /*0050*/               @P0 BRA 0x90 ;                                  /* 0x0000000000000947 */
        /*0060*/                   F2I.TRUNC.NTZ R7, R4 ;                      /* 0x0000000400077305 */
        /*0070*/                   EXIT ;                                      /* 0x000000000000794d */
        /*0080*/                   NOP ;                                       /* 0x0000000000007918 */
		..........

		Function : _Z7no_jumpPiii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                                      /* 0x000000000000794d */
        /*0020*/                   BRA 0x20 ;                                  /* 0xfffffffc00fc7947 */
        /*0030*/                   NOP ;                                       /* 0x0000000000007918 */
"""


def test_probe_source_matches_the_header(tmp_path):
    """The probe kernel's source calls this design's leap_jump as the header
    declares it: it compiles on the host with a stand-in for CUDA's
    builtins (and the parent's call form is the six-argument one)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the probe source for the host")
    header = (_build.CSRC_DIR / "landing_sim.cuh").read_text()
    assert "struct LeapLane" in header
    src = tmp_path / "one_jump.cc"
    src.write_text(CUDA_SHIM + k2_leap_probe.probe_source(True))
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-fsyntax-only", "-I",
                    str(_build.CSRC_DIR), str(src)], check=True, capture_output=True)
    parent = k2_leap_probe.probe_source(False)
    assert "pika::leap_jump(x, y, vx, vy, c, FULL);" in parent and "LeapLane" not in parent


def test_parse_sass_and_classes():
    """Instructions by function, NOPs left out, predicated opcodes read past
    their guard; the jump's classes counted by opcode prefix."""
    functions = k2_leap_probe.parse_sass(SASS)
    assert set(functions) == {"_Z8one_jumpILb1EEvPiii", "_Z7no_jumpPiii"}
    body, base = functions["_Z8one_jumpILb1EEvPiii"], functions["_Z7no_jumpPiii"]
    assert len(body) == 8 and len(base) == 3
    assert k2_leap_probe.opcode("@P0 BRA 0x90") == "BRA"
    assert k2_leap_probe.classes(body) == {"conversions": 2, "MUFU": 1, "IMAD.HI / .WIDE": 1,
                                           "branches": 1, "votes": 1}
    assert k2_leap_probe.classes(base)["branches"] == 1


def test_kernel_key_drops_the_parameter_list():
    """K2's iter instance matches across its namespace prefix and parameter
    list; other kernels keep their whole name."""
    old = "_ZN12_GLOBAL__N_114landing_kernelILi0ELi0EEEvPKiS2_S2_S2_PiS3_iii"
    new = "_ZN12_GLOBAL__N_114landing_kernelILi0ELi0EEEvPKiS2_S2_S2_PiS3_iiiii"
    assert k2_leap_probe.kernel_key(old) == k2_leap_probe.kernel_key(new) \
        == "landing_kernelILi0ELi0EE"
    assert k2_leap_probe.kernel_key("_Z9flat_simsILb1EEvPKi") == "_Z9flat_simsILb1EEvPKi"


def test_checkout_paths(tmp_path):
    """A checkout root resolves to its csrc/, a csrc/ to itself."""
    (tmp_path / "pikazoo_tpu_torch" / "csrc").mkdir(parents=True)
    assert k2_leap_probe.csrc_of(str(tmp_path)) == tmp_path / "pikazoo_tpu_torch" / "csrc"
    assert k2_leap_probe.csrc_of(str(_build.CSRC_DIR)) == _build.CSRC_DIR


def test_cpu_run_holds_every_mode(capsys):
    assert k2_leap_probe.main(["--device", "cpu", "--batch", "64"]) == 0
    assert "each bit-equal to the frame loop" in capsys.readouterr().out

