"""WaveCAM's CAM stages of the PyTorch port's pipeline (`wsss/wavecam_pipeline.py`)
against the JAX package's, at the JAX tests' tiny configuration
(`wavecam_pipeline_common.TINY`), on the same weight files: JAX's own initial
`Net` and predictor variables, calmed (`wavecam_pipeline_common.calm`), written as
`weights/cam.npy` and `weights/wavecam.npy` for JAX and through
`convert/from_jax.py` for the port:

- `make_cam` and `make_wavecam`: the CAM dicts within 2e-4 of the largest (the
  worst are printed), and the reweighted CAMs differ from the plain ones;
- `eval_cam` on the same dict files within 1e-6.

JAX's stages run once, in a module-scoped fixture."""
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
from wavecam_pipeline_common import TINY, calm, numpy_sd, port, save_weights

torch.set_num_threads(2)

CAM_TOL = 2e-4      # max-normalised CAM dicts through ResNet-50
MIOU_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("jax_wavecam"))
    crop, n = TINY["crop_size"], TINY["n_classes"]
    net = calm(JR.Net(stride=16, n_classes=n).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, crop, crop, 3))), 1)
    pred = calm(JWM.ClassPredictorWavecam(n, 2048).init(
        jax.random.PRNGKey(1), jnp.zeros((1, n, 2048)), jnp.ones((1, n)),
        jnp.zeros((1, crop // 16, crop // 16, n))), 2)
    os.makedirs(os.path.join(work, "weights"))
    np.save(os.path.join(work, "weights", "cam.npy"), net, allow_pickle=True)
    np.save(os.path.join(work, "weights", "wavecam.npy"), {"net": net, "pred": pred},
            allow_pickle=True)
    pipe = JP.WaveCAMPipeline(JP.WaveCAMConfig(work_dir=work, **TINY))
    pipe.run(["make_cam"])
    shutil.copytree(os.path.join(work, "cam"), os.path.join(work, "cam_plain"))
    res = pipe.run(["make_wavecam", "eval_cam"])
    return dict(work=work, net=net, pred=pred, eval_cam=res["eval_cam"])


@pytest.mark.parametrize("wave", [False, True])
def test_make_cam_dicts_match_jax(jax_run, tmp_path, wave):
    pipe = port(tmp_path)
    net = numpy_sd(wavecam_net_state_dict_from_jax(jax_run["net"]))
    if wave:
        save_weights(pipe, "wavecam.npy", {
            "net": net, "pred": numpy_sd(wavecam_predictor_state_dict_from_jax(jax_run["pred"]))})
        pipe.run(["make_wavecam"])
        want_dir = os.path.join(jax_run["work"], "cam")
    else:
        save_weights(pipe, "cam.npy", net)
        pipe.run(["make_cam"])
        want_dir = os.path.join(jax_run["work"], "cam_plain")
    names = sorted(os.listdir(pipe.cfg.dir("cam")))
    assert names == sorted(os.listdir(want_dir)) and len(names) == TINY["synthetic_n"]
    worst = 0.0
    for name in names:
        got = np.load(os.path.join(pipe.cfg.dir("cam"), name), allow_pickle=True).item()
        want = np.load(os.path.join(want_dir, name), allow_pickle=True).item()
        assert set(got) == {"keys", "cam", "high_res"}
        np.testing.assert_array_equal(got["keys"], want["keys"])
        for k in ("cam", "high_res"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            err = np.abs(got[k] - want[k]).max(initial=0.0)
            assert err <= CAM_TOL * max(np.abs(want[k]).max(initial=0.0), 1e-30), (name, k, err)
            worst = max(worst, err)
    print(f"{'make_wavecam' if wave else 'make_cam'}: worst {worst:.3g}")


def test_wave_weights_change_the_cams(jax_run):
    """make_wavecam's dicts differ from make_cam's: the predictor reweights the
    classifier."""
    plain, wave = (os.path.join(jax_run["work"], d) for d in ("cam_plain", "cam"))
    differ = 0
    for name in sorted(os.listdir(wave)):
        a = np.load(os.path.join(plain, name), allow_pickle=True).item()
        b = np.load(os.path.join(wave, name), allow_pickle=True).item()
        differ += a["high_res"].size > 0 and not np.allclose(a["high_res"], b["high_res"])
    assert differ > 0


def test_eval_cam_matches_jax_on_the_same_files(jax_run, tmp_path):
    pipe = port(tmp_path)
    shutil.copytree(os.path.join(jax_run["work"], "cam"), pipe.cfg.dir("cam"),
                    dirs_exist_ok=True)
    got = pipe.run(["eval_cam"])["eval_cam"]
    assert 0.0 <= got <= 1.0
    assert abs(got - jax_run["eval_cam"]) <= MIOU_TOL
