"""ViTPose+ served on boxes of mixed tasks (``pose_step(..., tasks=)``).

On the CPU, at a tiny ViTPose+ (D 128, 2 blocks, 4 heads, the six tasks,
32 expert rows a task) with seeded random weights, the routed step's plain
versions are held to the benchmark's plain reference
(``h100_bench/reference/vitpose_plus_ref.py``), the routed features to the
task-spliced int8 model's bit for bit, and planted faults fail.

The tests marked ``cuda`` hold the grouped int8 GEMM and the routed step to
the dense kernels and the spliced model on the card; this file imports no
JAX, so they run there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_plus_routed.py -q
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "h100_bench") not in sys.path:
    sys.path.insert(0, str(ROOT / "h100_bench"))

from easy_vitpose_tpu_torch import configs as tc  # noqa: E402
from easy_vitpose_tpu_torch.convert.model_split import SPLIT_DATASETS  # noqa: E402
from easy_vitpose_tpu_torch.models import moe, quant  # noqa: E402
from easy_vitpose_tpu_torch.models.vit import vit_forward  # noqa: E402
from easy_vitpose_tpu_torch.models.vitpose import serving_copy  # noqa: E402
from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step  # noqa: E402
from reference import vitpose_plus_ref  # noqa: E402
from reference.compare_plus import plus_numbers  # noqa: E402

D, DEPTH, HEADS = 128, 2, 4
CFG = tc.ModelConfig("plustiny", "coco", tc.BackboneConfig(embed_dim=D, depth=DEPTH, num_heads=HEADS),
                     tc.HeadConfig(in_channels=D, num_keypoints=17, deconv_filters=(32, 32)))
REF_CFG = {"depth": DEPTH, "num_heads": HEADS, "layer_norm_eps": CFG.backbone.layer_norm_eps,
           "patch_size": 16, "patch_padding": 2, "deconv_filters": [32, 32]}
KS = (17, 14, 16, 17, 17, 133)
H, W, M = 120, 160, 10
# The port serves in bf16 with W8A8 blocks; the reference keeps float32
# between its W8A8 products.  Over the mixes below the sound step reads a
# score gap of at most 0.0090 of a map's range and a median move of at most
# 0.0197 heatmap px; the int4 control reads at least 0.0195 and 0.0485, a
# wrong expert a score gap of at least 0.038.  The limits lie between.
SCORE_TOL, MOVE_TOL = 0.015, 0.035
MIXES = {
    "all_six": ([5, 0, 3, 0, 1, 5, 2, 4, 0, 0], M - 2),
    "one_task_absent": ([0, 0, 3, 5, 2, 4, 0, 3, 5, 0], M - 2),
    "a_task_with_one_crop": ([0, 0, 0, 3, 5, 0, 3, 3, 0, 0], M),
    "masked_between": ([1, 0, 5, 0, 2, 4, 3, 0, 1, 5], None),
}


@pytest.fixture(scope="module")
def params():
    return moe.init_vitpose_plus_params(CFG, 11, tasks=SPLIT_DATASETS)


@pytest.fixture(scope="module")
def model(params):
    return moe.PlusQ8(params, CFG)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    x1, y1 = rng.uniform(0, W - 30, M), rng.uniform(0, H - 30, M)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 80, M), y1 + rng.uniform(10, 90, M)], -1)
    return frame, torch.from_numpy(boxes.astype(np.float32))


def mix(name):
    tasks, live = MIXES[name]
    mask = np.arange(M) < live if live is not None else np.arange(M) % 3 != 1
    return np.array(tasks), torch.from_numpy(mask)


def routed_numbers(model, params, scene, name):
    frame, boxes = scene
    tasks, mask = mix(name)
    kp = pose_step(model, frame, boxes, mask, tasks=tasks, device="cpu")
    heats, ref, geo = vitpose_plus_ref.pose(params, frame, boxes, tasks, REF_CFG, 8)
    return kp, plus_numbers(kp, mask, tasks, heats, ref, geo)[0]


@pytest.mark.parametrize("name", list(MIXES))
def test_routed_step_holds_to_the_reference(model, params, scene, name):
    kp, nums = routed_numbers(model, params, scene, name)
    assert kp.shape == (M, max(KS), 3)
    assert nums["score_gap"] <= SCORE_TOL and nums["moved_median"] <= MOVE_TOL, nums
    assert nums["not_finite"] == nums["masked_nonzero"] == nums["beyond_k_nonzero"] == 0


@pytest.mark.parametrize("name", list(MIXES))
def test_rows_past_each_k_and_masked_boxes_are_zero(model, scene, name):
    frame, boxes = scene
    tasks, mask = mix(name)
    kp = pose_step(model, frame, boxes, mask, tasks=tasks, device="cpu")
    for i, t in enumerate(tasks):
        assert torch.count_nonzero(kp[i, KS[t]:]) == 0
        assert bool(mask[i]) == bool(torch.count_nonzero(kp[i, :KS[t]]))


@pytest.mark.parametrize("task", range(len(SPLIT_DATASETS)))
def test_routed_features_equal_the_spliced_int8_model(model, params, task):
    """A crop's features through the routed blocks, in a batch of six tasks,
    are the bits of the task-spliced int8 model's on the same batch: the
    integer sums are exact and the expert's rounding is per row.  (The CPU's
    bf16 products round by batch size, so the batch is the same one here;
    the card's kernels do not, and its test holds each task's crops alone.)"""
    g = torch.Generator().manual_seed(task)
    tasks = np.array([5, task, 0, 3, task, 1, 2, 4])
    x = torch.randn((len(tasks), 256, 192, 3), generator=g).bfloat16()
    r = moe.Routing(tasks, len(SPLIT_DATASETS), 192).to("cpu")
    xs = x[torch.from_numpy(r.order)]
    with torch.no_grad():
        feats = moe.routed_backbone(model, xs, r)
        spliced = serving_copy(moe.task_model(params, CFG, SPLIT_DATASETS[task]), "int8")
        want = vit_forward(spliced.backbone, xs)
    (_, first, end), = [s for s in r.slices if s[0] == task]
    assert torch.equal(feats[first:end], want[first:end])
    assert not torch.equal(feats, want)          # the other tasks' crops met their own experts


def swap_experts(model, a=0, b=3):
    bad = copy.deepcopy(model)
    for blk in bad.backbone.blocks:
        for n in ("ex_wq", "ex_s", "ex_b"):
            t = getattr(blk, n)
            t[[a, b]] = t[[b, a]].clone()
    return bad


def swap_heads(model, a=0, b=3):
    bad = copy.deepcopy(model)
    bad.heads[a], bad.heads[b] = bad.heads[b], bad.heads[a]
    return bad


@pytest.mark.parametrize("fault", [swap_experts, swap_heads])
def test_a_planted_fault_fails_the_comparison(model, params, scene, fault):
    """Coco's and ap10k's experts (or heads) traded: the crops of those two
    tasks meet another task's weights, and the score gap shows it."""
    _, sound = routed_numbers(model, params, scene, "all_six")
    _, bad = routed_numbers(fault(model), params, scene, "all_six")
    assert sound["score_gap"] <= SCORE_TOL < bad["score_gap"], (sound, bad)


@pytest.mark.parametrize("name", list(MIXES))
def test_the_int4_control_fails_the_comparison(params, scene, name):
    """The reference at int4 in the program's place fails both limits: they
    are tighter than one precision down."""
    frame, boxes = scene
    tasks, mask = mix(name)
    heats, ref, geo = vitpose_plus_ref.pose(params, frame, boxes, tasks, REF_CFG, 8)
    _, low, _ = vitpose_plus_ref.pose(params, frame, boxes, tasks, REF_CFG, 4)
    low = torch.where(mask[:, None, None], low, torch.zeros_like(low))
    nums = plus_numbers(low, mask, tasks, heats, ref, geo)[0]
    assert nums["score_gap"] > SCORE_TOL and nums["moved_median"] > MOVE_TOL, nums


def test_routing_orders_by_task_and_tables_the_groups():
    tasks = np.array([5, 0, 3, 0, 1, 5, 0])
    r = moe.Routing(tasks, 6, 192)
    assert r.order.tolist() == [1, 3, 6, 4, 2, 0, 5]
    assert (r.order[r.inverse] == np.arange(7)).all()
    assert r.slices == [(0, 0, 3), (1, 3, 4), (3, 4, 5), (5, 5, 7)]
    assert r.groups.tolist() == [[0, 576, 0, 0], [576, 192, 1, 0], [768, 192, 3, 0],
                                 [960, 384, 5, 0]]
    r.to("cpu")
    assert r.order_t.tolist() == r.order.tolist() and r.inverse_t.tolist() == r.inverse.tolist()
    assert r.groups_t.dtype == torch.int32 and r.groups_t.tolist() == r.groups.tolist()


def test_routing_refuses_tasks_out_of_range():
    with pytest.raises(ValueError):
        moe.Routing(np.array([0, 6]), 6, 192)
    with pytest.raises(ValueError):
        moe.Routing(np.array([[0, 1]]), 6, 192)


def test_counters_count_rows_and_heads_by_task(model, scene):
    frame, boxes = scene
    tasks, mask = mix("one_task_absent")
    moe.reset_routing_counts()
    pose_step(model, frame, boxes, mask, tasks=tasks, device="cpu")
    n = np.bincount(tasks, minlength=6)
    want = {SPLIT_DATASETS[t]: DEPTH * int(n[t]) * 192 for t in range(6) if n[t]}
    assert moe.routed_rows() == {"padded": 0, **want}
    assert moe.head_launches() == {SPLIT_DATASETS[t]: 1 for t in range(6) if n[t]}


def test_route_and_heads_spans_nest_in_order(model, scene):
    from harness import trace

    frame, boxes = scene
    tasks, mask = mix("one_task_absent")
    with trace.profiled(True) as prof:
        pose_step(model, frame, boxes, mask, tasks=tasks, device="cpu")
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.events
                    if e.name().startswith("evt.") and str(e.device_type()).endswith("CPU")))
    step = [s for s in spans if s[2] == "evt.pose.step"]
    assert len(step) == 1
    top = [s for s in spans if s[2] != "evt.pose.step" and s[2] != "evt.pose.head"]
    assert [s[2] for s in top] == ["evt.pose.route", "evt.pose.sample", "evt.pose.backbone",
                                   "evt.pose.heads", "evt.pose.decode"]
    (a, b, _), = [s for s in top if s[2] == "evt.pose.heads"]
    heads = [s for s in spans if s[2] == "evt.pose.head"]
    assert len(heads) == len(set(tasks)) and all(a <= h0 and h1 <= b for h0, h1, _ in heads)


def test_mixed_tasks_need_a_plus_copy_and_host_tasks(model, scene, params):
    frame, boxes = scene
    tasks, mask = mix("all_six")
    single = serving_copy(moe.task_model(params, CFG, "coco"), "int8")
    with pytest.raises(ValueError):
        pose_step(single, frame, boxes, mask, tasks=tasks, device="cpu")
    with pytest.raises(ValueError):
        pose_step(model, frame, boxes, mask, device="cpu")
    with pytest.raises(ValueError):
        pose_step(model, frame, boxes, mask, tasks=tasks, device="cpu", flip_pairs=[[1, 2]])


def test_plus_copy_keeps_scales_of_the_spliced_rows(params):
    """Each fc2 row is quantized alone: the shared rows' and each expert's
    scales are those of the spliced model's rows."""
    model = moe.PlusQ8(params, CFG)
    spliced = serving_copy(moe.task_model(params, CFG, "mpii"), "int8")
    for qp, qs in zip(model.backbone.blocks, spliced.backbone.blocks):
        ns = qp.fc2_wq.shape[0]
        assert torch.equal(qs.fc2_wq[:ns], qp.fc2_wq) and torch.equal(qs.fc2_wq[ns:], qp.ex_wq[2])
        assert torch.equal(qs.fc2_s, torch.cat([qp.fc2_s, qp.ex_s[2]]))
    assert model.num_keypoints == KS
    assert all(h.final_layer.weight.dtype == torch.bfloat16 for h in model.heads)


# --------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def q8_inputs(dev, M, K, E, NE, NS, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
    sx = (torch.rand(M, generator=g) * 0.02 + 1e-3).to(dev)
    ws = torch.randint(-127, 128, (NS, K), generator=g, dtype=torch.int8).to(dev)
    we = torch.randint(-127, 128, (E, NE, K), generator=g, dtype=torch.int8).to(dev)
    ss, se = (torch.rand(NS, generator=g) * 1e-3).to(dev), (torch.rand(E, NE, generator=g) * 1e-3).to(dev)
    bs, be = torch.randn(NS, generator=g).to(dev), torch.randn(E, NE, generator=g).to(dev)
    return q, sx, ws, we, ss, se, bs, be


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("crops", [(3, 0, 5, 1, 2, 7), (0, 0, 0, 0, 0, 1), (11, 13, 1, 0, 9, 30)])
@pytest.mark.parametrize("D", [1280, 1024, 768])
def test_grouped_gemm_matches_the_dense_product_of_spliced_rows(card, out_dtype, crops, D):
    """A ViTPose+ fc2 (ViT-H: K 5120, 960 shared rows, six experts of 320;
    ViT-L and -B alike at their widths): each group's rows through the
    grouped GEMM, and every row through the pitched dense GEMM, are the bits
    of the dense GEMM over the group's rows and its spliced weights; rows of
    no group are left as they were."""
    from easy_vitpose_tpu_torch.models.fused_block import EPI_RESIDUAL

    K, E, NE, NS, T = 4 * D, 6, D // 4, D - D // 4, 192
    M = (sum(crops) + 2) * T                       # two crops' rows in no group
    q, sx, ws, we, ss, se, bs, be = q8_inputs(card, M, K, E, NE, NS, sum(crops))
    x1 = torch.randn((M, NS + NE), device=card).to(out_dtype)
    rows = np.cumsum([0, *crops]) * T
    groups = torch.tensor([[rows[e], rows[e + 1] - rows[e], e, 0] for e in range(E)
                           if crops[e]], dtype=torch.int32, device=card)
    out = torch.full_like(x1, 7.0)
    quant.gemm_q8_rows_cuda(q, sx, ws, ss, bs, out_dtype, EPI_RESIDUAL, x1[:, :NS].contiguous(),
                            out=out)
    before = quant.grouped_gemm_launches()
    quant.gemm_q8_grouped_cuda(q, sx, we, se, be, groups, len(groups), x1, out, NS)
    assert quant.grouped_gemm_launches() == before + 1
    for e in range(E):
        r0, r1 = int(rows[e]), int(rows[e + 1])
        if r0 == r1:
            continue
        want = quant.gemm_q8_rows_cuda(q[r0:r1], sx[r0:r1], torch.cat([ws, we[e]]),
                                       torch.cat([ss, se[e]]), torch.cat([bs, be[e]]), out_dtype,
                                       EPI_RESIDUAL, x1[r0:r1])
        assert torch.equal(out[r0:r1], want), e
    assert (out[int(rows[-1]):, NS:] == 7.0).all()


@pytest.mark.cuda
def test_routed_step_on_the_card(card):
    """A ViTPose+-B of two blocks on the card: the routed step launches one
    grouped GEMM a block, queues with no host sync, and its features for
    each task's crops are the spliced int8 model's bits."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.ops.sampler import crop_normalize

    cfg = tc.ModelConfig("plusb2", "coco", tc.BackboneConfig(embed_dim=768, depth=2, num_heads=12),
                         tc.HeadConfig(in_channels=768, num_keypoints=17))
    params = {k: v.to(card) for k, v in
              moe.init_vitpose_plus_params(cfg, 3, tasks=SPLIT_DATASETS).items()}
    model = moe.PlusQ8(params, cfg)
    rng = np.random.default_rng(1)
    frame = torch.from_numpy(rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)).to(card)
    x1, y1 = rng.uniform(0, 600, 12), rng.uniform(0, 320, 12)
    boxes = torch.from_numpy(np.stack([x1, y1, x1 + 40, y1 + 60], -1).astype(np.float32)).to(card)
    mask = torch.ones(12, dtype=torch.bool, device=card)
    tasks = np.array([5, 0, 3, 0, 1, 5, 2, 0, 0, 3, 5, 0])        # apt36k has no crop
    pose_step(model, frame, boxes, mask, tasks=tasks)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    moe.reset_routing_counts()
    before = quant.grouped_gemm_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kp = pose_step(model, frame, boxes, mask, tasks=tasks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n_groups = len(set(tasks))
    assert quant.grouped_gemm_launches() - before == 2
    assert kernels.launch_counts() == {"sampler": 1, "block_q8": 2, "decode": n_groups}
    n = np.bincount(tasks, minlength=6)
    assert moe.routed_rows() == {"padded": 0, **{SPLIT_DATASETS[t]: 2 * int(n[t]) * 192
                                                 for t in range(6) if n[t]}}
    plain = pose_step(model, frame, boxes, mask, tasks=tasks, plain=True)
    for i, t in enumerate(tasks):
        assert torch.count_nonzero(kp[i, KS[t]:]) == 0
    assert torch.isfinite(kp).all() and float((kp[..., 2] - plain[..., 2]).abs().max()) < 0.05
    r = moe.Routing(tasks, 6, 192).to(card)
    x, _ = crop_normalize(frame, boxes.index_select(0, r.order_t), IMAGE_SIZE, torch.bfloat16)
    feats = moe.routed_backbone(model, x, r)
    for e, first, end in r.slices:
        spliced = serving_copy(moe.task_model(params, cfg, SPLIT_DATASETS[e]), "int8")
        own = torch.from_numpy(np.flatnonzero(tasks == e)).to(card)
        xe, _ = crop_normalize(frame, boxes.index_select(0, own), IMAGE_SIZE, torch.bfloat16)
        assert torch.equal(feats[first:end], vit_forward(spliced.backbone, xe)), e
