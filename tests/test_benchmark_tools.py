"""The measurement tools under benchmarks/, off the card: the int8
digit-plane reproducer's own reference (both plane types exact on the
CPU), and the trace reduction's per-operation split."""

import os
import sys

import pytest

import pailliercryptolib_tpu as ptpu

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks")
sys.path.insert(0, BENCH)

import int8_dot_repro  # noqa: E402
import trace_summary  # noqa: E402


@pytest.fixture(scope="module")
def repro_lines():
    key = ptpu.generate_keypair(256, enable_DJN=True)
    return list(int8_dot_repro.run(key, [3]))


@pytest.mark.parametrize("piece", int8_dot_repro.PIECES)
def test_int8_repro_exact_on_cpu(repro_lines, piece):
    """Every piece is exact with both plane types on the CPU, and only the
    int8 programs hold int8 arrays: the reproducer's expected values and
    its patching of mul_shared are right."""
    got = {ln["planes"]: ln for ln in repro_lines if ln["piece"] == piece}
    assert set(got) == {"int8", "bf16"}
    for kind, ln in got.items():
        assert ln["wrong"] == 0, ln
        assert ln["rows"] == (6 if piece == "mul_low" else 3)
        assert ln["s8"] == (kind == "int8"), ln


@pytest.mark.parametrize(
    "name,cls",
    [
        ("gemm_fusion_dot_97", "gemm"),
        ("cublasLt_matmul", "gemm"),
        ("input_concatenate_fusion_11", "other"),
        ("loop_select_fusion_13", "other"),
        ("MemcpyD2D", "memcpy"),
    ],
)
def test_trace_kernel_class(name, cls):
    assert trace_summary.kernel_class(name) == cls


def test_trace_per_operation(capsys):
    """Two annotated calls of one operation: per-call span, busy time,
    gaps, kernel count and class split, averaged over the calls."""
    ms = 1_000_000
    evs = [
        ("gemm_fusion_dot_1", 0 * ms, 2 * ms),
        ("loop_add_fusion", 3 * ms, 6 * ms),   # 1 ms gap before it
        ("gemm_fusion_dot_1", 10 * ms, 12 * ms),
        ("loop_add_fusion", 12 * ms, 15 * ms),  # no gap
        ("gemm_fusion_dot_1", 50 * ms, 51 * ms),  # outside both spans
    ]
    spans = {"decrypt": [(0, 9 * ms), (10 * ms, 20 * ms)]}
    trace_summary.per_operation(spans, evs, top=2)
    out = capsys.readouterr().out
    assert ("op decrypt: 2 x; per call: device span 5.500 ms, busy 5.000 ms, "
            "gaps 0.500 ms (9.09%), 2.0 kernels") in out
    assert "gemm 2.000 ms (40.0%, 1.0 kernels)" in out
    assert "other 3.000 ms (60.0%, 1.0 kernels)" in out
