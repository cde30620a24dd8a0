"""`utils/affine.py` and `utils/profiling.py` of the port against the JAX
package's: the affine sampler equal bit for bit on the same numpy Generator
seeds (scaling, translation, rotation, with and without artifacts),
`apply_affine` within 1e-5 at an identity and a rotated matrix, `StepRate`
equal under one patched clock, and `trace` writing a trace file on the CPU."""
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_common import nchw, nhwc
from representationlearning_tpu.utils import affine as JA
from representationlearning_tpu.utils import profiling as JP
from representationlearning_tpu_torch.utils import affine as TA
from representationlearning_tpu_torch.utils import profiling as TP

torch.set_num_threads(2)

KINDS = {"scaling": dict(do_scaling=True, scaling_low=0.7, scaling_up=1.3, do_rotation=False),
         "translation": dict(do_translation=True, do_rotation=False, patch_ratio=0.8,
                             translation_overflow=0.05),
         "rotation": dict(),
         "all": dict(do_scaling=True, scaling_low=0.8, scaling_up=1.2, do_translation=True,
                     patch_ratio=0.7, rotation=(-0.3, 0.5))}


@pytest.mark.parametrize("kind,artifacts", itertools.product(sorted(KINDS), (True, False)))
def test_affine_sample_equals_jax(kind, artifacts):
    kw = dict(KINDS[kind], allow_artifacts=artifacts)
    if not artifacts:   # at the default 1.2 no transform stays inside the unit square
        kw["patch_ratio"] = min(kw.get("patch_ratio", 0.6), 0.6)
    port, ref = TA.AffineAugmentation(**kw), JA.AffineAugmentation(**kw)
    for seed in range(5):
        got = port(np.random.default_rng(seed), 32, 32)
        want = ref(np.random.default_rng(seed), 32, 32)
        assert got.shape == (2, 3) and np.array_equal(got, want)
    src = np.array([[0, 0], [0, 1], [1, 1]], np.float32)
    dst = np.array([[0.1, 0.2], [0.0, 0.9], [1.1, 0.8]], np.float32)
    assert np.array_equal(TA.get_affine_transform(src, dst), JA.get_affine_transform(src, dst))


@pytest.mark.parametrize("M", [np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
                               JA.AffineAugmentation(patch_ratio=0.9).sample(
                                   np.random.default_rng(3))])
def test_apply_affine_matches_jax(M):
    x = np.random.default_rng(4).standard_normal((2, 17, 23, 3)).astype(np.float32)
    want = np.asarray(JA.apply_affine(jnp.asarray(x), M))
    got = TA.apply_affine(nchw(x), M)
    assert got.shape == (2, 3, 17, 23) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    if np.array_equal(M, np.eye(2, 3)):
        np.testing.assert_allclose(nhwc(got), x, atol=1e-5)


def test_step_rate_equals_jax(monkeypatch):
    now = [0.0]
    monkeypatch.setattr("time.perf_counter", lambda: now[0])
    port, ref = TP.StepRate(warmup=2), JP.StepRate(warmup=2)
    assert port.imps == ref.imps == 0.0 and port.step_ms == ref.step_ms == 0.0
    for n in (4, 4, 8, 8, 6):
        now[0] += 0.25
        port.update(n)
        ref.update(n)
        assert (port.n_steps, port.n_items, port.t0) == (ref.n_steps, ref.n_items, ref.t0)
    now[0] += 0.1
    assert port.imps == ref.imps == pytest.approx(22 / 0.85)
    assert port.step_ms == ref.step_ms == pytest.approx(850 / 3)


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    with TP.trace(str(tmp_path), activities=("cpu",)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and os.path.getsize(tmp_path / files[0]) > 0
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert TP.device_memory_stats() == {}
