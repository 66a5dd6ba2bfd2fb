"""The port's spans (``utils/profiling.py::span``): a shared no-op without a
profiler, ``record_function`` ranges under the benchmark's profile (the
card's operations and ``record_function``'s user scope only), nested where
the work happens in the pose step, the training step and ``VitInference``,
and one span per collection of Python's generation 1 or 2.  Also the
reading of a profile's spans by ``scripts/trace_spans.py`` on synthetic
events: device time to the innermost span by correlation id, idle gaps
named by the innermost span, host time in CUDA calls per span."""
import gc
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "h100_bench"), str(ROOT / "scripts")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import inputs, trace, weights  # noqa: E402

import trace_spans  # noqa: E402
from easy_vitpose_tpu_torch.utils import profiling  # noqa: E402

TINY = {"embed_dim": 64, "depth": 2, "num_heads": 2, "deconv_filters": [16, 16]}


def tiny_config(name: str) -> dict:
    c = json.loads((ROOT / "h100_bench" / "configs" / f"{name}.json").read_text())
    c.update(TINY)
    return c


def program_spans(events):
    """(start, end, name) of every ``evt.*`` span on the host but the
    collector's, in order of start (outer first)."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
           if e.name().startswith("evt.") and not e.name().startswith("evt.gc.")
           and str(e.device_type()).endswith("CPU")]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def inside(spans, outer: str):
    """Names of the spans inside each ``outer`` span, in order of start."""
    return [[n for a, b, n in spans if a0 <= a and b <= b0 and (a, b, n) != (a0, b0, outer)]
            for a0, b0, o in spans if o == outer]


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError("a record_function was built with no profiler")
    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("evt.pose.step"), profiling.span("evt.train.step")
    assert a is b is profiling._NO_SPAN
    with a:
        pass


def test_span_records_under_the_benchmark_profile():
    """The guard reads true inside ``profiled(True)`` on the thread that
    opens spans and in a backward there, and the span is recorded."""
    seen = []

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.autograd._profiler_enabled())
            with profiling.span("evt.test.backward"):
                return 2 * g

    x = torch.ones(4, requires_grad=True)
    with trace.profiled(True) as prof:
        with profiling.span("evt.test.outer"):
            seen.append(torch.autograd._profiler_enabled())
            Twice.apply(x).sum().backward()
    assert seen == [True, True]
    names = [n for _, _, n in program_spans(prof.events)]
    assert names == ["evt.test.outer", "evt.test.backward"]
    assert not torch.autograd._profiler_enabled()


@pytest.fixture(scope="module")
def pose_model():
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy

    cfg = weights.port_config(tiny_config("vitpose-b-int8"))
    w = weights.vitpose_weights(cfg, 5, "cpu")
    return serving_copy(weights.vitpose_model(cfg, w, "cpu"), "fp32")


@pytest.mark.parametrize("flip", [False, True])
def test_pose_step_spans_nest_in_order(pose_model, flip):
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step
    from easy_vitpose_tpu_torch.skeletons import flip_pairs

    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = inputs.make_boxes(rng, 4, 120, 160)
    with trace.profiled(True) as prof:
        pose_step(pose_model, frame, boxes, np.arange(4) < 3, device="cpu",
                  flip_pairs=flip_pairs("coco") if flip else None)
    spans = program_spans(prof.events)
    assert [n for _, _, n in spans].count("evt.pose.step") == 1
    fwd = ["evt.pose.backbone", "evt.pose.head"] * (2 if flip else 1)
    assert inside(spans, "evt.pose.step") == [["evt.pose.sample", *fwd, "evt.pose.decode"]]


def test_train_step_spans_nest_in_order():
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    c = tiny_config("vitpose-l-finetune-q8m")
    cfg = weights.port_config(c)
    p0 = weights.vitpose_weights(cfg, 7, "cpu")
    tx = fused_opt.make_fused_adam(1e-4, max_grad_norm=1.0, moment_dtype="int8")
    state = tstep.init_train_state(p0, tx, device="cpu")
    step = tstep.make_train_step(cfg, tx, use_amp=True, render_kwargs={"sigma": 2.0})
    data = inputs.train_batches(7, 1, 2, c["num_keypoints"], c["img_size"], "cpu")
    masks = inputs.drop_path_masks(7, 1, c["depth"], 2, c["drop_path_rate"], "cpu")
    with trace.profiled(True) as prof:
        step(state, {k: v[0] for k, v in data.items()}, None, masks[0])
    spans = program_spans(prof.events)
    assert inside(spans, "evt.train.step") == [["evt.train.render", "evt.train.forward",
                                                "evt.train.backward", "evt.train.optimizer"]]


def gc_spans(events, name):
    return sum(e.name() == name for e in events)


@pytest.mark.parametrize("generation", [1, 2])
def test_a_collection_is_one_span_under_a_profile_only(generation):
    name = f"evt.gc.gen{generation}"
    with trace.profiled(True) as prof:
        with trace.span(trace.WINDOW):
            gc.collect(generation)
    assert gc_spans(prof.events, name) == 1
    with trace.profiled(True) as prof:
        with trace.span(trace.WINDOW):
            pass
    gc.collect(generation)          # after the profile: nothing recorded, nothing left open
    assert gc_spans(prof.events, name) == 0
    assert getattr(profiling._gc_open, "rf", None) is None


def test_a_stop_with_no_start_is_ignored():
    profiling._gc_span("stop", {"generation": 2})
    assert getattr(profiling._gc_open, "rf", None) is None


def test_reimporting_leaves_one_collector_hook():
    def hooks():
        return [cb for cb in gc.callbacks if getattr(cb, "__qualname__", "") == "_gc_span"
                and getattr(cb, "__module__", "") == profiling.__name__]
    assert len(hooks()) == 1
    importlib.reload(profiling)
    importlib.reload(profiling)
    assert len(hooks()) == 1
    with trace.profiled(True) as prof:
        gc.collect(2)
    assert gc_spans(prof.events, "evt.gc.gen2") == 1


def test_stage_timer_stage_opens_its_span():
    timer = profiling.StageTimer()
    with trace.profiled(True) as prof:
        with timer.stage("evt.frame.pose"):
            torch.ones(4).sum()
    assert [n for _, _, n in program_spans(prof.events)] == ["evt.frame.pose"]
    assert timer.counts["evt.frame.pose"] == 1


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny pose model's float32 weights as a JAX-format ``.npz``, and a
    random YOLOv8n ``.npz`` scaled on the test frame."""
    from easy_vitpose_tpu_torch.convert.from_jax import state_dict_to_jax
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.utils.checkpoint import save_params

    d = tmp_path_factory.mktemp("spans")
    cfg = weights.port_config(tiny_config("vitpose-b-int8"))
    sd = weights.vitpose_weights(cfg, 5, "cpu")
    npz = str(d / "vitpose-s-coco.npz")
    save_params(npz, state_dict_to_jax(sd, cfg))
    det = str(d / "yolov8n.npz")
    yolo.save_yolo_npz(det, yolo.init_yolo_params(0, yolo.YoloSpec("n"), frame(), 160), "n")
    return {"npz": npz, "yolo": det, "cfg": cfg}


def frame():
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    f = np.stack([np.sin(xx / 11), np.cos(yy / 13), np.sin((xx + yy) / 17)], -1)
    return ((f - f.min()) / np.ptp(f) * 255).astype(np.uint8)


FRAME_SPANS = {"evt.frame.upload", "evt.frame.dispatch", "evt.frame.fetch", "evt.frame.track"}


@pytest.mark.parametrize("mode", ["boxes", "fused", "pipelined"])
def test_a_frame_records_its_stages(checkpoint, mode):
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    vi = VitInference(checkpoint["npz"], yolo=None if mode == "boxes" else checkpoint["yolo"],
                      model_name="s", model_cfg=checkpoint["cfg"], yolo_size=160,
                      device="cpu", is_video=mode == "pipelined", max_people=4)
    img = frame()
    with trace.profiled(True) as prof:
        if mode == "boxes":
            vi.inference(img, bboxes=np.array([[10, 10, 90, 110, 0.9]], np.float32))
        elif mode == "fused":
            vi.inference(img)
        else:
            vi.inference_pipelined(img)
            vi.inference_pipelined(img)
            vi.flush()
    names = {n for _, _, n in program_spans(prof.events)}
    assert FRAME_SPANS <= names


# ------------------------------------------------ scripts/trace_spans.py
class Event:
    """A profile event as ``torch.profiler`` gives it (``_KinetoEvent``)."""

    def __init__(self, name, start, end, device="CPU", corr=0, annotation=False):
        self._n, self._a, self._d = name, start, end - start
        self._dev, self._c, self._u = device, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._u


def synthetic_events():
    """A window of two steps on the host (spans in ns): step 1 launches a
    backbone kernel (corr 1) and a head kernel (corr 2); a collection runs
    inside step 2's backbone, which launches corr 3; the harness's copy
    (corr 4) is launched outside every program span.  The card idles
    longest while the collector holds the host."""
    ev = [Event("bench.window", 0, 1000, annotation=True),
          Event("bench.enqueue", 10, 400, annotation=True),
          Event("evt.pose.step", 20, 390, annotation=True),
          Event("evt.pose.backbone", 30, 200, annotation=True),
          Event("evt.pose.head", 210, 380, annotation=True),
          Event("bench.enqueue", 500, 900, annotation=True),
          Event("evt.pose.step", 510, 890, annotation=True),
          Event("evt.pose.backbone", 520, 880, annotation=True),
          Event("evt.gc.gen2", 600, 800, annotation=True),
          Event("cudaLaunchKernel", 40, 50, corr=1),
          Event("cuLaunchKernel", 220, 235, corr=2),
          Event("cudaLaunchKernel", 850, 860, corr=3),
          Event("cudaMemcpyAsync", 420, 425, corr=4),
          Event("evt.pose.backbone", 100, 300, device="CUDA", annotation=True),
          Event("k_backbone", 100, 300, device="CUDA", corr=1),
          Event("k_head", 300, 420, device="CUDA", corr=2),
          Event("copy_DtoH", 430, 450, device="CUDA", corr=4),
          Event("k_backbone", 870, 990, device="CUDA", corr=3)]
    return ev


def test_split_gives_device_time_to_the_launching_span():
    out = trace_spans.split(synthetic_events(), steps=2)
    s = out["spans"]
    # by the launch call's host time, not by when the kernel ran
    assert s["evt.pose.backbone"]["device_ms_per_step"] == pytest.approx(1e-6 * 320 / 2)
    assert s["evt.pose.head"]["device_ms_per_step"] == pytest.approx(1e-6 * 120 / 2)
    assert s["evt.pose.step"]["device_ms_per_step"] == 0.0
    assert out["device_ms_per_step_no_span"] == pytest.approx(1e-6 * 20 / 2)
    assert out["no_span_ops_ms_per_step"] == [["copy_DtoH", pytest.approx(1e-5)]]
    assert s["evt.pose.head"]["top_ops_ms_per_step"] == [["k_head", pytest.approx(6e-5)]]
    assert out["span_share_of_device_pct"] == pytest.approx(100 * 440 / 460)


def test_split_names_gaps_and_counts_host_calls_per_span():
    out = trace_spans.split(synthetic_events(), steps=2)
    # gaps: 450-870 (the collector inside step 2's backbone), 0-100 (step 1's
    # backbone at its middle), 420-430 and 990-1000 (outside every span)
    assert [g[0] for g in out["idle_gaps"]] == ["evt.gc.gen2", "evt.pose.backbone", "host",
                                                "host"]
    assert out["idle_gaps"][0][1] == pytest.approx(420e-6)
    s = out["spans"]
    assert s["evt.pose.step"]["count"] == 2
    assert s["evt.pose.step"]["call_ms_median"] == pytest.approx(1e-6 * (25 + 10) / 2)
    assert s["evt.pose.backbone"]["host_ms_median"] == pytest.approx(1e-6 * (170 + 360) / 2)
    assert out["gc_share_pct"] == pytest.approx(100 * 200 / 1000)
    assert out["cuda_calls"] == 4 and out["slow_calls"] == []


def test_split_of_a_cpu_profile_has_spans_and_no_device_time(pose_model):
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    rng = np.random.default_rng(4)
    frame_ = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    with trace.profiled(True) as prof:
        with trace.span(trace.WINDOW):
            pose_step(pose_model, frame_, inputs.make_boxes(rng, 2, 120, 160),
                      np.ones(2, bool), device="cpu")
    out = trace_spans.split(prof.events, steps=1)
    assert out["span_share_of_device_pct"] is None and out["cuda_calls"] == 0
    assert out["spans"]["evt.pose.step"]["count"] == 1
    assert out["spans"]["evt.pose.backbone"]["host_ms_median"] > 0
