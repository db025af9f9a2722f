"""The port's CUDA build helper (``x2i_torch/ops/cuda_lib.py``) on the CPU:
what ``ptxas_report`` reads out of ``nvcc -Xptxas -v`` output (registers,
spills, a serialized ``wgmma`` pipeline), the faults ``build_faults`` finds
in it, and that a library's file name follows its source, every shared
header and the flags. No compiler and no
card are needed: the ptxas text is canned, in the form nvcc 12 prints it
for ``sm_90a``, and the sources are a copy of ``csrc/`` under ``tmp_path``.
"""

import shutil

import pytest

from x2i_torch.ops import cuda_lib

_TU = "_ZN42_GLOBAL__N__0000_12_flash_fwd_cu"
KERNEL = _TU + "16flash_fwd_kernelILi128ELi2ELb1ELi0EEEvNS_4ArgsE"
ROPE = _TU + "16rope_rows_kernelILi128EEEvPK13__nv_bfloat16"


def _entry(name, regs, stores=0, loads=0):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {8 if stores else 0} bytes stack frame, {stores} bytes "
            f"spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 3 barriers, 688 "
            f"bytes cmem[0]\n")


SERIALIZED = (
    "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
    "instructions are serialized due to non wgmma instructions defining "
    "accumulator registers of a wgmma between start and end of the pipeline "
    f"stage in the function '{KERNEL}'\n")
HEAD = "ptxas info    : 0 bytes gmem\n"

CASES = {
    "clean": (HEAD + _entry(KERNEL, 207) + _entry(ROPE, 28),
              {KERNEL: (207, 0, False), ROPE: (28, 0, False)}),
    "spilled": (HEAD + _entry(KERNEL, 255, 1204, 768) + _entry(ROPE, 28),
                {KERNEL: (255, 1972, False), ROPE: (28, 0, False)}),
    # ptxas prints the warning before the entry it belongs to
    "serialized": (HEAD + SERIALIZED + _entry(KERNEL, 246) + _entry(ROPE, 28),
                   {KERNEL: (246, 0, True), ROPE: (28, 0, False)}),
    "serialized-after": (HEAD + _entry(ROPE, 28) + _entry(KERNEL, 246)
                         + SERIALIZED,
                         {KERNEL: (246, 0, True), ROPE: (28, 0, False)}),
    "empty": ("", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ptxas_report(case):
    log, want = CASES[case]
    got = cuda_lib.ptxas_report(log)
    assert got == {name: {"registers": regs, "spill_bytes": spill,
                          "wgmma_serialized": ser}
                   for name, (regs, spill, ser) in want.items()}


DQ = ("_ZN42_GLOBAL__N__0000_12_flash_bwd_cu19flash_bwd_dq_kernel"
      "ILi128ELb0ELb0EEEvNS_7TileMapES1_NS_7BwdArgsE")
DKV = ("_ZN42_GLOBAL__N__0000_12_flash_bwd_cu20flash_bwd_dkv_kernel"
       "ILi128ELb0ELb0EEEvNS_7TileMapES1_NS_7BwdArgsE")
BWD = (DQ, DKV)
IGNORED = ("ptxas info    : (C7508) Potential Performance Loss: "
           "'setmaxnreg' ignored; unable to determine register count at "
           "entry\n")

# case -> (log, the faults build_faults finds, by a word of each line)
FAULT_CASES = {
    "clean": (HEAD + _entry(DQ, 168) + _entry(DKV, 236) + _entry(ROPE, 28),
              []),
    "spilled": (HEAD + _entry(DQ, 168) + _entry(DKV, 240, 96, 96)
                + _entry(ROPE, 28), ["spills"]),
    "serialized": (HEAD + _entry(DQ, 168) + _entry(DKV, 236)
                   + SERIALIZED.replace(KERNEL, DKV), ["serialized"]),
    "setmaxnreg-ignored": (HEAD + IGNORED + _entry(DQ, 168)
                           + _entry(DKV, 236), ["setmaxnreg"]),
    "missing-kernel": (HEAD + _entry(DQ, 168) + _entry(ROPE, 28),
                       ["flash_bwd_dkv_kernel"]),
    "no-register-count": (HEAD + _entry(DQ, 168)
                          + _entry(DKV, 236).rsplit("ptxas info", 1)[0],
                          ["register count"]),
}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_build_faults(case):
    """The build gate of the wgmma kernels: a clean log passes, and each
    fault that leaves a kernel right but slow is named."""
    log, want = FAULT_CASES[case]
    faults = cuda_lib.build_faults(log, ("flash_bwd_dq_kernel",
                                         "flash_bwd_dkv_kernel"))
    assert len(faults) == len(want)
    for fault, word in zip(faults, want):
        assert word in fault


def test_flash_libraries_gate_their_wgmma_kernels():
    """Every instance, and by name the head dim 256 instances of K1, K2,
    K3 and K4 (K4's roles kernel in each of its six instances, <ROPE,
    MASKED, OutT>, and K4's reduce kernel at 256), K1's f32 rope-and-norm
    instance at D = 128 and K1's D = 64 grid instance at three blocks an
    SM (mangled template arguments <D, WGS, MINB, ROPE, BODY, float>)."""
    from x2i_torch.ops import flash_attention as tfa
    assert tfa.KERNEL.wgmma_kernels == (
        "flash_fwd_kernel", "flash_fwd_kernelILi256E",
        "flash_fwd_kernelILi128ELi2ELi1ELb1ELi0EfE",
        "flash_fwd_kernelILi64ELi1ELi3E")
    roles = "flash_bwd_dkv_roles_kernelI"
    assert tfa.KERNEL_BWD.wgmma_kernels == (
        "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
        "flash_bwd_dq_kernelILi256E",
        f"{roles}Lb0ELb0E13__nv_bfloat16E", f"{roles}Lb0ELb1E13__nv_bfloat16E",
        f"{roles}Lb1ELb0E13__nv_bfloat16E", f"{roles}Lb1ELb1E13__nv_bfloat16E",
        f"{roles}Lb0ELb0EfE", f"{roles}Lb0ELb1EfE")
    assert tfa.KERNEL_BWD.gated_kernels == tfa.KERNEL_BWD.wgmma_kernels + (
        "round_rows_kernel", "dkv_reduce_kernelILi256E")
    assert tfa.KERNEL_CHUNKED.wgmma_kernels == ("flash_chunked_kernel",
                                                "flash_chunked_kernelILi256E")


def test_gemm_library_gates_its_wgmma_kernel():
    """The int8 GEMM, the w4a8 GEMM and the dequantizing GEMM of w4 and w8
    are built on wgmma (each GEMM's bf16, f32 and int32 outputs are
    instances of its name); the w4 dequantize kernel and the
    straight-through backward's int8 and w4a8 dequantize kernels beside
    them (the first two with their f32 instances) are gated too."""
    from x2i_torch.ops import int8_gemm as tgemm
    assert tgemm.GEMM.wgmma_kernels == ("int8_gemm_kernel",
                                        "w4a8_gemm_kernel",
                                        "dequant_gemm_kernel")
    assert tgemm.GEMM.gated_kernels == ("int8_gemm_kernel",
                                        "w4a8_gemm_kernel",
                                        "dequant_gemm_kernel",
                                        "w4_dequant_kernel",
                                        "int8_dequant_kernel",
                                        "w4a8_dequant_kernel")


# the instances of K2 (D, masked) and of the int8 GEMM (its output: bf16,
# f32, the int32 accumulator), named as nvcc 12 mangles them
_CHUNKED_TU = "_ZN49_GLOBAL__N__9351ae3b_16_flash_chunked_cu_be12862a"
CHUNKED = tuple(
    f"{_CHUNKED_TU}20flash_chunked_kernelILi{d}ELb{m}EEEvNS_7TileMapES1_S1_"
    f"NS_4ArgsE" for d in (64, 128) for m in (0, 1))
_GEMM_TU = "_ZN49_GLOBAL__N__b0cd12f3_12_int8_gemm_cu_004656628"
GEMM_KERNELS = tuple(
    f"{_GEMM_TU}16int8_gemm_kernelILi{o}EEEv14CUtensorMap_stS1_NS_4ArgsE"
    for o in (0, 1, 2))
# the w4a8 GEMM's instances (its output) in the same library
W4A8_KERNELS = tuple(
    f"{_GEMM_TU}16w4a8_gemm_kernelILi{o}EEEv14CUtensorMap_stS1_NS_4ArgsE"
    for o in (0, 1, 2))
# the dequantizing GEMM's instances (w4, w8) in the same library
DEQUANT_GEMM_KERNELS = tuple(
    f"{_GEMM_TU}19dequant_gemm_kernelILi{m}EEEv14CUtensorMap_stS1_NS_4ArgsE"
    for m in (1, 2))
LIBRARY_KERNELS = {"flash_chunked": (CHUNKED, "flash_chunked_kernel"),
                   "int8_gemm": (GEMM_KERNELS, "int8_gemm_kernel"),
                   "w4a8_gemm": (W4A8_KERNELS, "w4a8_gemm_kernel"),
                   "dequant_gemm": (DEQUANT_GEMM_KERNELS,
                                    "dequant_gemm_kernel")}


def _library_log(names, spill=None, serialized=None):
    """A build log of every instance in ``names``: 168 registers each (the
    start of a 384-thread block), 84 + 84 bytes of spills in ``spill``, a
    serialized pipeline in ``serialized``."""
    log = HEAD
    for name in names:
        log += _entry(name, 168, *((84, 84) if name == spill else ()))
        if name == serialized:
            log += SERIALIZED.replace(KERNEL, name)
    return log


# case -> (log of the library's instances, the faults by a word of each)
LIBRARY_CASES = {
    "clean": (lambda k: _library_log(k), []),
    "spilled": (lambda k: _library_log(k, spill=k[-1]), ["spills"]),
    "serialized": (lambda k: _library_log(k, serialized=k[0]),
                   ["serialized"]),
    "setmaxnreg-ignored": (lambda k: IGNORED + _library_log(k),
                           ["setmaxnreg"]),
    "every instance missing": (lambda k: HEAD + _entry(ROPE, 28),
                               ["names no kernel"]),
}


@pytest.mark.parametrize("case", list(LIBRARY_CASES))
@pytest.mark.parametrize("library", list(LIBRARY_KERNELS))
def test_build_faults_of_the_chunked_and_gemm_libraries(library, case):
    """The build gate on K2's, the int8 GEMM's, the w4a8 GEMM's and the
    dequantizing GEMM's wgmma instances: a clean log passes, and each
    fault that leaves them right but slow is named, as for K1, K3 and
    K4."""
    names, gate = LIBRARY_KERNELS[library]
    make, want = LIBRARY_CASES[case]
    faults = cuda_lib.build_faults(make(names), (gate,))
    assert len(faults) == len(want), faults
    for fault, word in zip(faults, want):
        assert word in fault


# the row glue library's kernels (K5, K6 and K8's warp body, K5's and K6's
# generic instance, K7's and K8's ring kernel and their generic one, then
# K8's halves: the row absmax and the codes at a given absmax, warp body
# and generic; then the f32 instances: f32_rows_kernel for K5, K6, K8 and
# K7 at 4 and 16 chunks a thread),
# named as nvcc 12 mangles them; none is built on wgmma
_ROW_TU = "_ZN49_GLOBAL__N__5c1e07a2_11_row_glue_cu_8d2f6b41"
ROW_GLUE_KERNELS = (
    f"{_ROW_TU}13ln_mod_kernelENS_7RowArgsE",
    f"{_ROW_TU}19ln_mod_quant_kernelENS_7RowArgsE",
    f"{_ROW_TU}17quant_warp_kernelENS_7RowArgsE",
    *(f"{_ROW_TU}18ln_mod_rows_kernelILb{q}EEEvNS_7RowArgsE" for q in (0, 1)),
    *(f"{_ROW_TU}17quant_ring_kernelILb{g}EEEvNS_7RowArgsE" for g in (0, 1)),
    *(f"{_ROW_TU}17quant_rows_kernelILb{g}ELi2EEEvNS_7RowArgsE"
      for g in (0, 1)),
    f"{_ROW_TU}20row_amax_warp_kernelENS_7RowArgsE",
    f"{_ROW_TU}20quant_at_warp_kernelENS_7RowArgsE",
    *(f"{_ROW_TU}17quant_rows_kernelILb0ELi{op}EEEvNS_7RowArgsE"
      for op in (3, 4)),
    *(f"{_ROW_TU}15f32_rows_kernelILi{op}ELi{c}EEEvNS_10F32RowArgsE"
      for op in (0, 1, 2, 5) for c in (4, 16)))


def _row_glue_log(drop=(), spill=None, no_regs=None):
    log = HEAD
    for name in ROW_GLUE_KERNELS:
        if name in drop:
            continue
        entry = _entry(name, 72, *((40, 40) if name == spill else ()))
        if name == no_regs:
            entry = entry.rsplit("ptxas info", 1)[0]
        log += entry
    return log


# case -> (log, the faults by a word of each)
ROW_GLUE_CASES = {
    "clean": (_row_glue_log(), []),
    "K7 spilled": (_row_glue_log(spill=ROW_GLUE_KERNELS[6]), ["spills"]),
    "K5 spilled": (_row_glue_log(spill=ROW_GLUE_KERNELS[0]), ["spills"]),
    "K6 spilled": (_row_glue_log(spill=ROW_GLUE_KERNELS[1]), ["spills"]),
    "K7 missing": (_row_glue_log(drop=ROW_GLUE_KERNELS[5:7]),
                   ["quant_ring_kernel"]),
    "K8 missing": (_row_glue_log(drop=ROW_GLUE_KERNELS[2]),
                   ["quant_warp_kernel"]),
    "K8's halves missing": (_row_glue_log(drop=ROW_GLUE_KERNELS[9:11]),
                            ["row_amax_warp_kernel",
                             "quant_at_warp_kernel"]),
    "no register count": (_row_glue_log(no_regs=ROW_GLUE_KERNELS[0]),
                          ["register count"]),
    "f32 K7 spilled": (_row_glue_log(spill=ROW_GLUE_KERNELS[-1]),
                       ["spills"]),
    "f32 K5 missing": (_row_glue_log(drop=ROW_GLUE_KERNELS[13:15]),
                       ["f32_rows_kernelILi0E"]),
    "f32 rows kernel missing": (_row_glue_log(drop=ROW_GLUE_KERNELS[13:]),
                                ["f32_rows_kernel", "f32_rows_kernelILi0E"]),
}


@pytest.mark.parametrize("case", list(ROW_GLUE_CASES))
def test_build_faults_of_the_row_glue_library(case):
    """The build gate on the row glue library (K5-K8), whose kernels are not
    built on wgmma: a spill in any of them fails the build, as does a
    kernel the log does not name."""
    from x2i_torch.ops import fused_glue as tfg
    log, want = ROW_GLUE_CASES[case]
    faults = cuda_lib.build_faults(log, tfg.ROW_GLUE.gated_kernels)
    assert len(faults) == len(want), faults
    for fault, word in zip(faults, want):
        assert word in fault


SASS = """
		Function : _ZN12quant_kernelILb1EEEvNS_9QuantArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R3, R2 ;
        /*0020*/              @!P0 MUFU.RCP R3, R2 ;
        /*0030*/                   F2FP.BF16.F32.PACK_AB R3, R2, R1 ;
        /*0040*/                   F2I.S32 R3, R2 ;
        /*0050*/                   FRND R3, R2 ;
		Function : other_kernel
        /*0000*/                   MUFU.EX2 R3, R2 ;
"""


def test_sass_census_counts_the_special_function_and_conversion_ops():
    """The script behind PERF.md's instruction counts of K7: per kernel,
    MUFU apart, the conversions (F2I, I2F, F2F, FRND) apart, and F2FP (a
    packing conversion, not the conversion unit's) apart, per element."""
    from x2i_torch.tools import sass_census
    got = sass_census.census(SASS)
    assert got == {"_ZN12quant_kernelILb1EEEvNS_9QuantArgsE": {
        "LDC": 1, "MUFU": 2, "F2FP": 1, "F2I": 1, "FRND": 1},
        "other_kernel": {"MUFU": 1}}
    rec = sass_census.classify(got["_ZN12quant_kernelILb1EEEvNS_9QuantArgsE"],
                               2)
    assert rec == {"instructions": 6, "MUFU": 2, "MUFU_per_element": 1.0,
                   "conversion": 2, "conversion_per_element": 1.0,
                   "F2FP": 1, "F2FP_per_element": 0.5}


def test_row_glue_library_gates_every_kernel():
    from x2i_torch.ops import fused_glue as tfg
    assert tfg.ROW_GLUE.wgmma_kernels == ()
    assert tfg.ROW_GLUE.gated_kernels == (
        "ln_mod_kernel", "ln_mod_quant_kernel", "quant_warp_kernel",
        "ln_mod_rows_kernel", "quant_ring_kernel", "quant_rows_kernel",
        "row_amax_warp_kernel", "quant_at_warp_kernel", "f32_rows_kernel",
        "f32_rows_kernelILi0E")
    # no gated kernel name is a part of another kernel's, so each names
    # its own (K5's f32 instances: the template arguments <0, C> of one)
    for gated in tfg.ROW_GLUE.gated_kernels:
        ident = gated.split("ILi")[0]
        assert [n for n in ROW_GLUE_KERNELS
                if gated in n] == [n for n in ROW_GLUE_KERNELS
                                   if f"{len(ident)}{gated}" in n]
    assert tfg.ROW_GLUE.src.name == "row_glue.cu" and tfg.ROW_GLUE.src.exists()


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` and an empty build directory under tmp_path."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, copy)
    monkeypatch.setattr(cuda_lib, "CSRC", copy)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "_build")
    return copy


def _flash_library():
    return cuda_lib.CudaLibrary("flash_fwd.cu", "libx2i_flash", ("k",),
                                lambda lib: None)


@pytest.mark.parametrize("edited,changes", [
    ("flash_common.cuh", True), ("hopper_mma.cuh", True),
    ("flash_fwd.cu", True), ("int8_gemm.cu", False)])
def test_library_name_follows_source_and_headers(csrc_copy, edited, changes):
    """An edit to the library's source or to any shared header gives the
    library another file name (so it is rebuilt); another library's
    source does not."""
    lib = _flash_library()
    before = lib.library_path()
    assert before == lib.library_path()
    assert before.parent == cuda_lib.BUILD_DIR
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    assert (lib.library_path() != before) == changes


def test_library_name_follows_flags(csrc_copy, monkeypatch):
    lib = _flash_library()
    before = lib.library_path()
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        cuda_lib.NVCC_FLAGS + ("-DX2I_TEST",))
    assert lib.library_path() != before


def test_build_reuses_a_library_and_its_log(csrc_copy, monkeypatch):
    """A library that an earlier process built is not compiled again, and
    its ptxas log, kept beside it, is read back for the report."""
    lib = _flash_library()
    path = lib.library_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    path.with_suffix(".log").write_text(CASES["clean"][0])

    def no_compiler(*args, **kwargs):
        raise AssertionError("the compiler must not run")

    monkeypatch.setattr(cuda_lib.subprocess, "run", no_compiler)
    assert lib.build() == path
    assert cuda_lib.ptxas_report(lib.build_log)[KERNEL]["registers"] == 207


def test_build_failure_raises_with_the_log(csrc_copy, monkeypatch):
    """No fallback: a failed build raises, with the compiler's output."""
    class Failed:
        returncode, stdout, stderr = 1, "", "flash_fwd.cu(1): error: boom"

    monkeypatch.setattr(cuda_lib.subprocess, "run", lambda *a, **k: Failed())
    lib = _flash_library()
    with pytest.raises(RuntimeError, match="boom"):
        lib.build()
    assert not lib.library_path().exists()
