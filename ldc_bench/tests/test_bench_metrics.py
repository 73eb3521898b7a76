"""The metric readers and the trace reader, on synthetic jobs and a
synthetic trace."""

import pytest

from ldc_bench import spec, trace, work
from ldc_bench.drive import Job, Lane

CFG_SG = {"solver": "fsg", "reference": "spectral",
          "params": {"dtype": "float32"}}
CFG_FV = {"solver": "fv", "reference": "fv", "params": {"dtype": "float32"}}


def lane(iterations, levels, n=96):
    return Lane(params={}, n=n, state=(), converged=True,
                iterations=iterations, levels=levels, validation={})


def job(lanes, step_s=2.0, validate_s=0.1):
    return Job(kind="round" if len(lanes) > 1 else "solve", lanes=lanes,
               build_s=0.05, step_s=step_s, validate_s=validate_s,
               wall_s=0.05 + step_s + validate_s)


class Ev:
    """A KinetoEvent as the trace reader sees it."""

    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


# the window 0-1000 ns: kernels 100-300 and 250-400 (overlapping),
# 600-700, one partly outside the window (900-1100); a host operation
# covers 450-550, the benchmark's spans name the other gaps, and the
# profiler's labels (on the host and mirrored on the device) are no
# activity
EVENTS = [
    Ev("ldc_bench.solve", "CPU", 100, 700),
    Ev("ldc_bench.solve", "CUDA", 100, 700),
    Ev("cudaLaunchKernel", "CPU", 90, 5),
    Ev("aten::copy_", "CPU", 450, 100),
    Ev("void stage_kernel<float, 4>(Args)", "CUDA", 100, 200),
    Ev("void stage_kernel<float, 4>(Args)", "CUDA", 250, 150),
    Ev("tail_kernel(float*)", "CUDA", 600, 100),
    Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 900, 200),
]
SPANS = [("build", 0, 100), ("solve", 100, 780), ("validate", 780, 1000)]


def test_trace_read_takes_the_window():
    got = trace.read(EVENTS, 0, 1000, SPANS)
    assert got["window_s"] == pytest.approx(1000e-9)
    # union: 100-400, 600-700, 900-1000 (clipped)
    assert got["busy_s"] == pytest.approx(500e-9)
    ops = dict(got["device_ops"])
    assert ops["stage_kernel"] == pytest.approx(350e-9)
    assert ops["tail_kernel"] == pytest.approx(100e-9)
    gaps = dict(got["idle_gaps"])
    # 0-100 in build; 400-600 is named by its middle, in aten::copy_;
    # 700-900 by its middle, in validate
    assert gaps == pytest.approx({"ldc_bench.build": 100e-9,
                                  "aten::copy_": 200e-9,
                                  "ldc_bench.validate": 200e-9})
    # busy inside each span: solve 100-400 and 600-700 (to 780), validate
    # 900-1000
    assert got["span_busy_s"] == pytest.approx(
        {"build": 0.0, "solve": 400e-9, "validate": 100e-9})


def test_trace_read_clips_to_a_shorter_window():
    got = trace.read(EVENTS, 200, 650, SPANS)
    assert got["window_s"] == pytest.approx(450e-9)
    assert got["busy_s"] == pytest.approx(250e-9)


def ctx_of(kind, jobs, cfg=CFG_SG, tr=None):
    return {"kind": kind, "config": cfg, "jobs": jobs, "window_s": 10.0,
            "setup_s": 7.5, "launches": 5000, "trace": tr}


def read(name, ctx):
    return spec.reader(name)(ctx, name)


def test_solve_readers():
    jobs = [job([lane(1000, [(48, 990), (96, 10)])]),
            job([lane(1100, [(48, 1090), (96, 10)])])]
    ctx = ctx_of("solve", jobs)
    assert read("setup_s", ctx) == 7.5
    assert read("solve_s", ctx) == 5.0
    assert read("round_s", ctx) is None
    assert read("iterations.solve", ctx) == 1050
    assert read("iterations.round", ctx) is None
    assert read("steps_per_s.solve", ctx) == pytest.approx(2100 / 4.0)
    assert read("validate_ms.solve", ctx) == pytest.approx(100.0)
    assert read("launches_per_step.solve", ctx) == pytest.approx(5000 / 2100)
    # nothing traced: the device readers find nothing to read
    assert read("device_idle.solve", ctx) is None
    assert read("kernel_roofline.solve", ctx) is None


def test_round_readers_take_the_slowest_lane_a_level():
    lanes = [lane(300, [(20, 100), (40, 200)], 40),
             lane(250, [(20, 150), (40, 100)], 40)]
    ctx = ctx_of("round", [job(lanes)])
    assert read("round_s", ctx) == 10.0
    assert read("iterations.round", ctx) == 150 + 200
    assert read("steps_per_s.round", ctx) == pytest.approx(550 / 2.0)
    assert read("launches_per_step.round", ctx) == pytest.approx(5000 / 350)
    assert read("solve_s", ctx) is None


def test_device_readers_on_a_traced_job():
    # the traced job's own steps at each order, over the device time of
    # its solve span; idle over its whole window
    traced = job([lane(2000, [(48, 1000), (96, 1000)])])
    tr = {"busy_s": 0.5, "window_s": 2.0, "job": traced,
          "span_busy_s": {"build": 0.01, "solve": 0.4, "validate": 0.09}}
    ctx = ctx_of("solve", [], tr=tr)
    assert read("device_idle.solve", ctx) == pytest.approx(75.0)
    f48, b48 = work.steps_work(49, "float32", 1000, 1000 // 16)
    f96, b96 = work.steps_work(97, "float32", 1000, 1000 // 16)
    least = work.bound(f48 + f96, b48 + b96, "float32")[0]
    assert least == pytest.approx(work.steps_bound(49, "float32", 1000, 62)[0]
                                  + work.steps_bound(97, "float32", 1000,
                                                     62)[0])
    assert read("kernel_roofline.solve", ctx) == pytest.approx(
        100 * least / 0.4)
    fv = job([lane(6000, [(128, 6000)], 128)])
    ctx = ctx_of("solve", [], CFG_FV, {"busy_s": 2.0, "window_s": 2.1,
                                       "job": fv,
                                       "span_busy_s": {"solve": 1.5}})
    assert read("kernel_roofline.solve", ctx) == pytest.approx(
        100 * work.fv_iterations_bound(128, 128, "float32", 1, 6000)[0]
        / 1.5)


def test_round_roofline_counts_each_order_once():
    # a round capped at 10000 steps a level, 8 lanes at N=20 and N=40;
    # the N=20 part alone is PERF.md's bound of 8 lanes at N=20, 0.00011
    # ms a step with a quadrature pass every step, 0.000102 with one in 16
    lanes = [lane(20000, [(20, 10000), (40, 10000)], 40) for _ in range(8)]
    assert 8 * work.steps_bound(21, "float32", 1, 1)[0] == pytest.approx(
        0.00011e-3, rel=0.01)
    f20, b20 = work.steps_work(21, "float32", 10000, 625)
    assert 8 * f20 / work.PEAK_FLOPS["float32"] / 10000 == pytest.approx(
        0.000102e-3, rel=0.01)
    tr = {"busy_s": 1.2, "window_s": 5.0, "job": job(lanes),
          "span_busy_s": {"solve": 1.1}}
    ctx = ctx_of("round", [], tr=tr)
    f40, b40 = work.steps_work(41, "float32", 10000, 625)
    least = work.bound(8 * (f20 + f40), 8 * (b20 + b40), "float32")[0]
    assert read("kernel_roofline.round", ctx) == pytest.approx(
        100 * least / 1.1)
    # nothing stepped inside the solve span: nothing to read
    ctx["trace"]["span_busy_s"] = {"solve": 0.0}
    assert read("kernel_roofline.round", ctx) is None
