"""The port's bench entry point (`representationlearning_tpu_torch/bench.py`) on the
CPU: each workload's timed function at a small size against the JAX package on
the same weights (carried over by `convert/from_jax.py`) and the same numpy
draws, f32 (the RSSFormer predict and TTA in `test_torch_bench_rssformer.py`, the
RSSFormer train step in `test_torch_train_rssformer.py`); its lines, their keys
and error records; and the parent process with `subprocess.run` replaced by a
fake child. The card's measurements (`measure`) run in `chip_smoke.py` phase 9."""
import json
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_wavecam_net, state_dict_to_numpy
from representationlearning_tpu.models.resnet import Net as JNet
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.wsss import camutils as JCU
from representationlearning_tpu_torch import bench as TB
from representationlearning_tpu_torch.convert.from_jax import tscd_state_dict_from_jax
from representationlearning_tpu_torch.models.mit import FusedBlock
from representationlearning_tpu_torch.ops import _build
from representationlearning_tpu_torch.ops import affinity as TA
from representationlearning_tpu_torch.ops import mit_block as tmb
from representationlearning_tpu_torch.ops import varm as TV

torch.set_num_threads(2)

ATOL = 2e-4       # f32 end to end, the bound of tests/test_parity_torch_e2e.py:21
NEAR = 1e-3       # a label may differ only where the JAX side is this close to a tie
SMALL_MIT = dict(backbone="mit_b0", side=64, batch=2, dtype=torch.float32)


@pytest.fixture
def unported(monkeypatch):
    """A stand-in for a workload without a build function in `wavecam_cams`'s
    place (all seven are ported): its line is an error record naming the item."""
    spec = TB.Bench(TB.BENCHES["wavecam_cams"].metric, "CAMs/s", None,
                    "not ported yet: a stand-in, ROADMAP Queue 1 item 4")
    monkeypatch.setitem(TB.BENCHES, "wavecam_cams", spec)
    monkeypatch.setattr(TB, "PORTED", tuple(n for n in TB.PORTED if n != "wavecam_cams"))


@pytest.fixture
def no_kernels(monkeypatch):
    """On CPU tensors every wrapper runs its plain version: the loader is never asked."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def tscd_weights():
    x = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=21).init)(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(np.asarray, v)
    return v, tscd_state_dict_from_jax(v)


def test_headline_matches_jax(tscd_weights, no_kernels):
    """`model(x)[1]` of the fused model (plain K1 on the CPU) and its mean against
    the JAX TSCD without fused blocks on the same weights; the unfused twin that
    the FLOP count runs holds the same weights."""
    v, sd = tscd_weights
    w = TB.build_segformer_b1("cpu", **SMALL_MIT)
    assert w.batch == 2 and w.inputs["x"].shape == (2, 64, 64, 3)
    assert all(isinstance(b, FusedBlock) for b in w.model.encoder.block1)
    w.model.load_state_dict(sd)
    want = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=False).apply(
        v, jnp.asarray(w.inputs["x"]))[1]
    seg = w.run()
    assert seg.shape == (2, 21, 16, 16)
    np.testing.assert_allclose(seg.numpy(), _nchw(want), rtol=0, atol=ATOL)
    assert abs(float(w.call()) - float(jnp.mean(want))) <= ATOL
    assert abs(float(w.count()) - float(w.call())) <= 1e-5


def test_headline_draws_as_the_root_bench():
    """The images are default_rng(0)'s standard normal NHWC draws, as f32."""
    w = TB.build_segformer_b1("cpu", **SMALL_MIT)
    want = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(w.inputs["x"], want)


def test_scd_pseudo_labels_match_jax(tscd_weights, no_kernels):
    """The labels of `multi_scale_cam` + `cam_to_label` equal JAX's except at
    near-ties (the two best scores, or the best and the background score, within
    NEAR on the JAX side)."""
    v, sd = tscd_weights
    w = TB.build_scd_pseudo_labels("cpu", **SMALL_MIT)
    w.model.load_state_dict(sd)
    x, cls = jnp.asarray(w.inputs["x"]), jnp.asarray(w.inputs["cls_label"])
    model = JTSCD(backbone="mit_b0", num_classes=21)
    cam = JCU.multi_scale_cam(lambda im: model.apply(v, im, cam_only=True), x, (1.0, 0.5, 1.5))
    want = np.asarray(JCU.cam_to_label(cam, cls, bkg_score=0.45))
    got = w.run().numpy()
    assert got.shape == want.shape == (2, 64, 64)
    scores = np.sort(np.asarray(cam) * w.inputs["cls_label"][:, None, None, :], axis=-1)
    close = ((scores[..., -1] - scores[..., -2]) < NEAR) | (np.abs(scores[..., -1] - 0.45) < NEAR)
    assert not ((got != want) & ~close).any()
    assert len(np.unique(want)) > 2   # background and more than one class
    assert float(w.call()) == float(got.sum())


def test_rml_train_takes_a_step(no_kernels):
    """One call on raw canvases: finite losses, the total as the call's value, the
    step count moved; both FLOP counts run a step of their own. The step's parity
    with JAX is held by tests/test_torch_train_rml.py."""
    w = TB.build_rml_train("cpu", backbone="mit_b0", canvas=160, crop=128, image_hw=(150, 160),
                           batch=2, dtype=torch.float32, cam_scales=(1.0,))
    assert w.inputs["raw"].shape == (2, 160, 160, 3) and w.inputs["raw"].dtype == np.uint8
    assert w.inputs["cls_label"].sum(1).min() >= 1 and w.state.step == 0
    met = w.run()
    assert set(met) == {"cls", "apml", "mfml", "ciml", "total"}
    assert all(np.isfinite(float(t)) for t in met.values()) and w.state.step == 1
    assert float(w.reduce(met)) == float(met["total"])
    reference, measured = TB.count_flops(w.count), TB.count_flops(w.count_measured)
    assert reference >= measured > 0 and w.state.step == 3


def test_rml_draws_as_the_root_bench():
    """Raw canvases from int64 draws cast to uint8, then VOC-like labels, from one
    default_rng(0), as the root bench draws them."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (2, 160, 160, 3)).astype(np.uint8)
    cls = TB.voc_like_labels(rng, 2, 20)
    w = TB.build_rml_train("cpu", backbone="mit_b0", canvas=160, crop=128, batch=2,
                           dtype=torch.float32, cam_scales=(1.0,))
    np.testing.assert_array_equal(w.inputs["raw"], raw)
    np.testing.assert_array_equal(w.inputs["cls_label"], cls)
    assert set(np.unique(cls.sum(1))) <= {1.0, 2.0, 3.0}


def test_wavecam_cams_matches_jax(no_kernels):
    """One `cam` over [x; flip x], ReLU and the flip sum, against the root bench's
    `cam_fwd` on the JAX `Net` with the same weights (the port's state_dict through
    `convert_wavecam_net`), f32 at 2 x 64²."""
    w = TB.build_wavecam_cams("cpu", side=64, batch=2, dtype=torch.float32)
    want_x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(w.inputs["x"], want_x)
    v = convert_wavecam_net(state_dict_to_numpy(w.model.state_dict()), strict=True)
    x = jnp.asarray(w.inputs["x"])
    cc = JNet(n_classes=20).apply(v, jnp.concatenate([x, x[:, :, ::-1]], axis=0),
                                  method=JNet.cam)
    want = jnp.maximum(cc[:2], 0) + jnp.maximum(cc[2:], 0)[:, :, ::-1]
    cam = w.run()
    assert cam.shape == (2, 20, 4, 4) and w.batch == 2
    np.testing.assert_allclose(cam.numpy(), _nchw(want), rtol=0,
                               atol=ATOL * float(jnp.abs(want).max()))
    assert abs(float(w.call()) - float(jnp.mean(want))) <= ATOL * float(jnp.abs(want).max())
    assert float(w.count().mean()) == float(w.call())


def test_plain_kernels_swaps_k1_k2_k3_and_back():
    w = TB.build_segformer_b1("cpu", **SMALL_MIT)
    blocks = [m for m in w.model.modules() if isinstance(m, FusedBlock)]
    kernels = (TA.affinity, TV.varm_propagate)
    with TB.plain_kernels(w.model):
        assert all(b.block_fn is tmb.fused_block_reference for b in blocks)
        assert (TA.affinity, TV.varm_propagate) == (TA.affinity_reference,
                                                   TV.varm_propagate_reference)
    assert all(b.block_fn is tmb.fused_block for b in blocks)
    assert (TA.affinity, TV.varm_propagate) == kernels


def test_build_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name in TB.PORTED:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.BENCHES[name].build()


# ------------------------------------------------------------------ the lines
RECORD_KEYS = {"metric", "value", "unit", "achieved_tflops", "mfu", "flops_per_example_g",
               "ms_per_call", "launches_per_call", "device_busy_ms_per_call", "idle_share",
               "peak_mem_gib", "kernels", "card", "power_limit_w", "batch", "iters", "reps"}


def _record(name, card="NVIDIA H100 80GB HBM3", measured=None, loop_ms=(100.0,) * 3):
    kernels = TB.kernel_launches()
    return TB.make_record(name, batch=8, loop_ms=list(loop_ms), iters=10, busy_ms=7.5,
                          launches=420.0, peak_bytes=3 * 2**30, kernels=kernels, flops=8 * 30e9,
                          measured_flops=measured, card=card, power_limit_w=700.0)


@pytest.mark.parametrize("name", TB.PORTED)
def test_record_keys_and_values(name):
    measured = 8 * 25e9 if name == "rml_train" else None
    rec = _record(name, measured=measured)
    assert set(rec) == RECORD_KEYS | ({"measured_flops_per_example_g"} if measured else set())
    assert rec["metric"] == TB.BENCHES[name].metric and rec["unit"] == TB.BENCHES[name].unit
    assert rec["value"] == pytest.approx(800.0)
    assert rec["flops_per_example_g"] == pytest.approx(30.0)
    assert rec["achieved_tflops"] == pytest.approx(24.0)
    assert rec["mfu"] == pytest.approx(24e12 / 989e12)
    assert rec["idle_share"] == pytest.approx(0.25) and rec["peak_mem_gib"] == pytest.approx(3.0)
    assert set(rec["kernels"]) == {"K1", "K2", "K3", "K4", "K5", "K6"}
    if measured:
        assert rec["measured_flops_per_example_g"] == pytest.approx(25.0)
    assert "vs_baseline" not in rec and "baseline_a100_est" not in rec
    json.loads(json.dumps(rec))


def test_value_is_all_the_work_over_all_the_time():
    """A stalled loop moves the value and the idle share; the median time a call
    beside them does not."""
    rec = _record("segformer_b1", loop_ms=(100.0, 100.0, 400.0))
    assert rec["value"] == pytest.approx(8 * 30 * 1e3 / 600.0)
    assert rec["ms_per_call"] == pytest.approx(10.0) and rec["reps"] == 3
    assert rec["idle_share"] == pytest.approx(1.0 - 7.5 / 20.0)
    assert rec["achieved_tflops"] == pytest.approx(rec["value"] * 30e9 / 1e12)


def test_mfu_is_null_for_a_card_outside_the_table():
    rec = _record("segformer_b1", card="NVIDIA H100 PCIe")
    assert rec["mfu"] is None and rec["achieved_tflops"] == pytest.approx(24.0)


@pytest.mark.parametrize("name,item", [("wavecam_cams", "Queue 1 item 4")])
def test_unported_lines_are_error_records(name, item, capsys, unported):
    assert TB.run_one(name) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"metric": TB.BENCHES[name].metric, "value": 0.0, "unit": "error",
                   "error": TB.BENCHES[name].missing}
    assert "not ported yet" in rec["error"] and item in rec["error"]


def test_a_failing_child_prints_an_error_record(monkeypatch, capsys):
    def boom(name, **kw):
        raise RuntimeError("no CUDA device: test")

    monkeypatch.setattr(TB, "measure", boom)
    assert TB.run_one("segformer_b1") == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"metric": "segformer_b1_512_tiles_per_sec_per_chip", "value": 0.0,
                   "unit": "error", "error": "RuntimeError: no CUDA device: test"}


def test_measure_refuses_the_cpu(monkeypatch, unported):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.measure("segformer_b1")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TB.measure("wavecam_cams")


def test_no_tf32_turns_tf32_off_and_restores_the_settings(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with TB.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_one_from_the_command_line():
    """`python -m representationlearning_tpu_torch.bench --one NAME` prints its line
    last; without a card a workload exits 1 with its error record."""
    r = subprocess.run([sys.executable, "-m", TB.MODULE, "--one", "wavecam_cams"],
                       cwd=TB.ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert json.loads(r.stdout.strip().splitlines()[-1])["unit"] == "error"


def test_device_busy_is_the_union_of_device_events():
    events = [{"cat": "kernel", "ts": 0.0, "dur": 10.0},
              {"cat": "gpu_memcpy", "ts": 5.0, "dur": 10.0},     # overlaps the first
              {"cat": "gpu_memset", "ts": 30.0, "dur": 2.0},
              {"cat": "kernel", "ts": 31.0, "dur": 0.5},         # inside the fill
              {"cat": "cpu_op", "ts": 0.0, "dur": 100.0},        # host events do not count
              {"cat": "cuda_runtime", "ts": 40.0, "dur": 5.0},
              {"ph": "M", "name": "process_name"}]
    assert TB.device_busy(events) == (17.0, 4)
    assert TB.device_busy([]) == (0.0, 0)


def test_kernel_launches_per_call(monkeypatch):
    TB.reset_kernel_launches()
    monkeypatch.setitem(tmb.LAUNCHES, "linear", 80)
    monkeypatch.setitem(TV.LAUNCHES, "varm_propagate", 20)
    monkeypatch.setitem(TA.LAUNCHES, "affinity", 3)
    got = TB.kernel_launches(2)
    assert got["K1"] == {"ln_stats": 0, "linear": 40, "sr_conv": 0, "attention": 0,
                         "dwconv_gelu": 0}
    assert got["K3"] == {"varm_propagate": 10} and got["K2"] == {"affinity": 1.5}
    assert got["K5"] == {"mlp_fc1": 0, "mlp_taps": 0} and got["K6"] == {"isa_core": 0}


def test_last_record_is_the_last_metric_line():
    out = 'noise\n{"metric": "a", "value": 1}\n[1, 2]\n{"metric": "b", "value": 2}\n{"x": 1}\nend'
    assert json.loads(TB.last_record(out))["metric"] == "b"
    assert TB.last_record("no record\n{}\n") is None


# ------------------------------------------------------------------ the parent
@pytest.mark.parametrize("position,left,want", [
    (0, 1500.0, 120.0),          # its own cap
    (0, 600.0, 60.0),            # six pending keep 90 s each
    (6, 50.0, 50.0),             # the last takes what is left
    (3, 300.0, 30.0),            # below MIN_CHILD_S: skipped
])
def test_child_timeout_keeps_a_floor_for_the_pending(position, left, want):
    name = TB.BENCH_RUN_ORDER[position]
    assert TB.child_timeout(name, position, left) == pytest.approx(min(want,
                                                                       TB.PER_CONFIG_MAX_S[name]))


class _FakeChildren:
    """Stands in for `subprocess.run` of the children and for the parent's clock:
    each child takes `seconds[name]` and answers as `behave[name]` says."""

    def __init__(self, behave=None, seconds=None):
        self.behave, self.seconds = behave or {}, seconds or {}
        self.now, self.calls = 0.0, []

    def monotonic(self):
        return self.now

    def run(self, cmd, **kw):
        name = cmd[-1]
        self.calls.append((cmd, kw))
        self.now += self.seconds.get(name, 10.0)
        how = self.behave.get(name, "ok" if name in TB.PORTED else "unported")
        if how == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        if how == "silent":
            return subprocess.CompletedProcess(cmd, 1, stdout="loading\n",
                                               stderr="Traceback\nRuntimeError: boom\n")
        rec = (TB.error_record(name, TB.BENCHES[name].missing) if how == "unported" else
               TB.error_record(name, "RuntimeError: oom") if how == "error" else
               {"metric": TB.BENCHES[name].metric, "value": 1.5, "unit": TB.BENCHES[name].unit})
        return subprocess.CompletedProcess(cmd, 0 if how == "ok" else 1,
                                           stdout=f"warming\n{json.dumps(rec)}\n", stderr="")


@pytest.fixture
def parent(monkeypatch):
    def install(budget=1500.0, **kw):
        fake = _FakeChildren(**kw)
        built = []
        monkeypatch.setattr(_build, "build_all", lambda: built.append(1))
        monkeypatch.setattr(TB, "_versions", lambda: "versions")
        monkeypatch.setattr(TB.subprocess, "run", fake.run)
        monkeypatch.setattr(TB, "time", SimpleNamespace(monotonic=fake.monotonic))
        monkeypatch.setattr(TB, "BENCH_TOTAL_BUDGET_S", budget)
        fake.built = built
        return fake
    return install


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_parent_streams_then_prints_all_seven_headline_last(parent, capsys, unported):
    fake = parent()
    assert TB.main() == 0
    lines = _lines(capsys)
    assert fake.built == [1] and len(lines) == 14
    assert [r["metric"] for r in lines[:7]] == [TB.BENCHES[n].metric for n in TB.BENCH_RUN_ORDER]
    final = [r["metric"] for r in lines[7:]]
    assert final == [TB.BENCHES[n].metric for n in TB.BENCH_PRINT_ORDER]
    assert len(set(final)) == 7 and final[-1] == "segformer_b1_512_tiles_per_sec_per_chip"
    for cmd, kw in fake.calls:
        assert cmd[:4] == [sys.executable, "-m", "representationlearning_tpu_torch.bench", "--one"]
        assert kw["cwd"] == TB.ROOT and kw["capture_output"] and kw["text"]
    assert [c[0][-1] for c in fake.calls] == TB.BENCH_RUN_ORDER
    by_name = {r["metric"]: r for r in lines[7:]}
    assert by_name["wavecam_resnet50_cams_per_sec_per_chip"]["unit"] == "error"
    assert [r["unit"] for r in lines[7:]].count("error") == 1


def test_parent_caps_each_child_inside_the_budget(parent, capsys):
    """Each child's timeout is its cap, less the floor every later one keeps; the
    clock moves by each child's time, and a child left too little is skipped."""
    fake = parent(budget=900.0, seconds={"segformer_b1": 100.0, "rml_train": 490.0})
    assert TB.main() == 1   # a ported workload was skipped
    timeouts = {c[0][-1]: c[1]["timeout"] for c in fake.calls}
    assert timeouts["segformer_b1"] == pytest.approx(min(120, 900 - 6 * 90))
    assert timeouts["rml_train"] == pytest.approx(min(120, 800 - 5 * 90))
    # 310 s left after rml_train: rssformer_train would keep 4 floors (360 s) and
    # rssformer_tta_eval 3 (270 s), below MIN_CHILD_S both; wavecam_cams gets the rest
    assert "rssformer_train" not in timeouts and "rssformer_tta_eval" not in timeouts
    assert timeouts["wavecam_cams"] == pytest.approx(min(TB.PER_CONFIG_MAX_S["wavecam_cams"],
                                                         310 - 2 * 90))
    lines = {r["metric"]: r for r in _lines(capsys)[7:]}
    for name in ("rssformer_train", "rssformer_tta_eval"):
        skipped = lines[TB.BENCHES[name].metric]
        assert skipped["unit"] == "error" and skipped["error"].startswith("skipped: bench budget")


def test_parent_reports_a_timeout_and_a_silent_child(parent, capsys):
    parent(behave={"rml_train": "timeout", "scd_pseudo_labels": "silent"})
    assert TB.main() == 1
    lines = {r["metric"]: r for r in _lines(capsys)[7:]}
    rml = lines[TB.BENCHES["rml_train"].metric]
    assert rml["unit"] == "error" and rml["error"] == "timeout after 120 s"
    silent = lines[TB.BENCHES["scd_pseudo_labels"].metric]
    assert silent["unit"] == "error" and silent["value"] == 0.0
    assert silent["error"].startswith("exit=1") and "RuntimeError: boom" in silent["error"]


@pytest.mark.parametrize("failing,rc", [(None, 0), ("rssformer_predict", 1),
                                        ("rssformer_tta_eval", 1), ("rssformer_train", 1)])
def test_parent_fails_when_a_ported_workload_failed(parent, capsys, failing, rc):
    parent(behave={failing: "error"} if failing else {})
    assert TB.main() == rc
    lines = _lines(capsys)[7:]
    assert sum(r["unit"] == "error" for r in lines) == (failing is not None)


def test_parent_build_failure_fails_every_line(parent, monkeypatch, capsys):
    fake = parent()

    def broken():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "build_all", broken)
    assert TB.main() == 1
    lines = _lines(capsys)
    assert [r["metric"] for r in lines] == [TB.BENCHES[n].metric for n in TB.BENCH_PRINT_ORDER]
    assert all(r["unit"] == "error" and "nvcc not found" in r["error"] for r in lines)
    assert not fake.calls
