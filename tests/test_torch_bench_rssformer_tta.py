"""The port's bench entry point (`representationlearning_tpu_torch/bench.py`) on the
CPU, its RSSFormer six-scale TTA: `hrnetv2_w18` at 2 x 64 x 64 against the JAX
package on the same weights and the same numpy draws, f32 (the pieces shared with
the predict's test in `bench_rssformer_common.py`). Six eager JAX forwards make it the
slowest of the bench's tests."""
import jax.numpy as jnp
import numpy as np

from bench_rssformer_common import ATOL, SMALL_HRNET, _nchw, hrnet_weights, no_kernels  # noqa: F401
from representationlearning_tpu.infer.tta import default_tta_config as j_tta_config
from representationlearning_tpu.infer.tta import tta as j_tta
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu_torch import bench as TB


def test_rssformer_tta_eval_matches_jax(hrnet_weights, no_kernels):
    """The averaged probabilities of the six scales, before the argmax."""
    v, sd = hrnet_weights
    w = TB.build_rssformer_tta_eval("cpu", **SMALL_HRNET)
    w.model.load_state_dict(sd)
    model = JHRNetFusion("hrnetv2_w18", classes=7)
    want = np.asarray(j_tta(lambda im: model.apply(v, im), jnp.asarray(w.inputs["x"]),
                            j_tta_config()))
    pred = w.run()
    assert pred.shape == (2, 7, 64, 64)
    np.testing.assert_allclose(pred.numpy(), _nchw(want), rtol=0, atol=ATOL)
    assert float(w.call()) == float(pred.argmax(1).sum())
