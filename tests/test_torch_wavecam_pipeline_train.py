"""WaveCAM's pipeline of the PyTorch port (`wsss/wavecam_pipeline.py`): its
configuration, its samples and its two CAM trainers, against the JAX package's
pipeline at the JAX tests' tiny configuration (`wavecam_pipeline_common.TINY`):

- `WaveCAMConfig` has JAX's fields, order and defaults;
- `_cls_samples` and `_batches` are bit-equal to JAX's;
- `train_cam` and `train_wavecam` from the same initial weights (JAX's, calmed,
  carried across by `convert/from_jax.py`): every saved tensor within 1e-4 of its
  largest entry, the predictor's BatchNorm statistics included (`train_wavecam`
  against JAX's stage computed in f64, see its test). The worst are printed.

JAX's stages run once, in a module-scoped fixture; subclasses of its `Net` and
`ClassPredictorWavecam`, put in its pipeline module for that run, record their
initial variables (calmed first). The port starts each stage from JAX's files, so
that each stage is held on its own."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import resnet as JR
from representationlearning_tpu.models import wavecam as JWM
from representationlearning_tpu.wsss import wavecam_pipeline as JP
from representationlearning_tpu_torch.convert.from_jax import (
    wavecam_net_state_dict_from_jax, wavecam_predictor_state_dict_from_jax)
from representationlearning_tpu_torch.wsss import wavecam_pipeline as TP
from wavecam_pipeline_common import TINY, hold, numpy_sd, port, recorder, save_weights

torch.set_num_threads(2)

WEIGHT_TOL = 1e-4   # trained weights, of each tensor's largest entry


class Net64(JR.Net):
    dtype: object = jnp.float64


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("jax_wavecam"))
    init = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "Net", recorder(JR.Net, init, "net", seed=1))
        mp.setattr(JP, "ClassPredictorWavecam",
                   recorder(JWM.ClassPredictorWavecam, init, "pred", seed=2))
        JP.WaveCAMPipeline(JP.WaveCAMConfig(work_dir=work, **TINY)).run(
            ["train_cam", "train_wavecam"])
    # train_wavecam again from the same files, computed in f64
    work64 = str(tmp_path_factory.mktemp("jax_wavecam64"))
    os.makedirs(os.path.join(work64, "weights"))
    shutil.copy(os.path.join(work, "weights", "cam.npy"), os.path.join(work64, "weights"))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JP, "Net", Net64)
        mp.setattr(JP, "ClassPredictorWavecam",
                   recorder(JWM.ClassPredictorWavecam, {}, "pred", replay=init["pred"]))
        JP.WaveCAMPipeline(JP.WaveCAMConfig(work_dir=work64, **TINY)).train_wavecam()
    load = lambda w, name: np.load(os.path.join(w, "weights", name), allow_pickle=True).item()
    return dict(init=init, cam=load(work, "cam.npy"), wavecam=load(work, "wavecam.npy"),
                wavecam64=load(work64, "wavecam.npy"))


def test_config_matches_jax(tmp_path):
    got, want = dataclasses.fields(TP.WaveCAMConfig), dataclasses.fields(JP.WaveCAMConfig)
    assert [(f.name, f.default) for f in got] == [(f.name, f.default) for f in want]
    cfg = TP.WaveCAMConfig(work_dir=str(tmp_path / "w"))
    assert cfg.dir("cam") == os.path.join(str(tmp_path / "w"), "cam")
    assert os.path.isdir(cfg.dir("cam"))


@pytest.mark.parametrize("seed", [0, 3])
def test_cls_samples_and_batches_equal_jax(tmp_path, seed):
    jp = JP.WaveCAMPipeline(JP.WaveCAMConfig(work_dir=str(tmp_path / "j"), seed=seed, **TINY))
    tp = port(tmp_path / "t", seed=seed)
    for aug in (True, False):
        for (gn, gi, gl), (wn, wi, wl) in zip(tp._cls_samples(40, aug), jp._cls_samples(40, aug),
                                              strict=True):
            assert gn == wn and gi.dtype == wi.dtype == np.float32
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    got = list(tp._batches(40, 3, 2))
    want = list(jp._batches(40, 3, 2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_train_cam_matches_jax(jax_run, tmp_path, monkeypatch):
    start = numpy_sd(wavecam_net_state_dict_from_jax(jax_run["init"]["net"]))
    Net = TP.Net
    monkeypatch.setattr(TP, "Net", lambda **kw: TP._load_state(Net(**kw), start))
    pipe = port(tmp_path)
    pipe.train_cam()
    got = pipe._load("cam.npy")
    hold(got, numpy_sd(wavecam_net_state_dict_from_jax(jax_run["cam"])), WEIGHT_TOL, "train_cam")
    # the classifier and the trained BatchNorm scales moved; the statistics did not
    moved = lambda k: not np.array_equal(got[k], start[k])
    assert moved("classifier.weight") and moved("resnet50.bn1.weight")
    assert not moved("resnet50.bn1.running_mean")


def test_train_wavecam_matches_jax(jax_run, tmp_path, monkeypatch):
    """Held to JAX's stage computed in f64. The train-mode BatchNorms of the
    background branch see variances near their epsilon (the branch is (1 - x)/3),
    which makes their f32 gradients cancel: JAX's f32 stage lands 6.8e-4 of the
    largest entry of the classifier from its own f64 result (its f32 gradient of
    the predictor's loss on the CAMs is 9% off), while the port's f32 stage lands
    within 1e-6 of it (PyTorch's CPU BatchNorm sums in f64)."""
    pred0 = numpy_sd(wavecam_predictor_state_dict_from_jax(jax_run["init"]["pred"]))
    Pred = TP.ClassPredictorWavecam
    monkeypatch.setattr(TP, "ClassPredictorWavecam",
                        lambda *a, **kw: TP._load_state(Pred(*a, **kw), pred0))
    pipe = port(tmp_path)
    save_weights(pipe, "cam.npy", numpy_sd(wavecam_net_state_dict_from_jax(jax_run["cam"])))
    pipe.train_wavecam()
    got = pipe._load("wavecam.npy")
    assert set(got) == {"net", "pred"}
    for part, convert in (("net", wavecam_net_state_dict_from_jax),
                          ("pred", wavecam_predictor_state_dict_from_jax)):
        hold(got[part], numpy_sd(convert(jax_run["wavecam64"][part])), WEIGHT_TOL,
             f"train_wavecam {part} against JAX f64")
        want32 = numpy_sd(convert(jax_run["wavecam"][part]))
        assert all(got[part][k].dtype == v.dtype for k, v in want32.items())
    assert got["pred"]["wave.theta_R_bn.num_batches_tracked"] == 2   # two steps
    for k in ("wave.theta_R_bn.running_mean", "wave.theta_I_bn.running_var", "classifier"):
        assert not np.array_equal(got["pred"][k], pred0[k]), k
