"""The benchmark's arithmetic on hand-made samples."""
import json

import numpy as np
import pytest

from . import _paths  # noqa: F401
from portbench import profile, stats


def test_percentile_is_numpys_linear_rule_over_all_samples():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(size=257).tolist()
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)
    assert stats.percentile([4.0], 95) == 4.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_tail_is_taken_over_every_sample_not_chunk_medians():
    # two chunks: a quiet one and one with a long tail; the p95 of all samples
    # lies in the tail, the median of the chunks' p95s would not
    quiet, tail = [1.0] * 90, [1.0] * 80 + [10.0] * 10
    assert stats.percentile(quiet + tail, 95) == 10.0


def test_rate_is_all_work_over_all_time():
    assert stats.rate(900, 30.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_overlapping_intervals_count_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.busy_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.busy_seconds(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.gaps(iv, -1.0, 1.0) == [(-1.0, 0.0)]


def test_device_trace_reads_ops_and_launch_calls_on_the_host_clock():
    t0 = 500.0                         # host clock, s; the trace's own clock starts at 0
    shift = t0 - 5e-6
    doc = {"traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 4.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 94.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "quant_gemv_kernel<bf16>", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "quant_matmul_kernel", "ts": 12.0, "dur": 8.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 11.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 29.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 13.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]}
    tr = profile.parse(json.loads(json.dumps(doc)), t0, t0 + 100e-6,
                       (shift + 5e-6, shift + 95e-6))
    assert tr.aligned and tr.launches == 3
    assert tr.ops[0][1] == pytest.approx(shift + 10e-6, abs=1e-9)
    assert [n for n, _, _ in tr.ops] == ["quant_gemv_kernel<bf16>", "quant_matmul_kernel",
                                         "Memcpy DtoH"]
    busy = stats.busy_seconds([(a, b) for _, a, b in tr.ops], tr.t0, tr.t1)
    assert busy == pytest.approx(12e-6, rel=1e-6)       # 10-20 us and 30-32 us
