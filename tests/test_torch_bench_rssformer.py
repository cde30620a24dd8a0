"""The port's bench entry point (`representationlearning_tpu_torch/bench.py`) on the
CPU, its RSSFormer predict: `hrnetv2_w18` at 2 x 64 x 64 against the JAX package on
the same weights (a calmed model's, through `convert_rssformer` and back through
`convert/from_jax.py`) and the same numpy draws, f32. The six-scale TTA stands in
`test_torch_bench_rssformer_tta.py`."""
import jax.numpy as jnp
import numpy as np

from bench_rssformer_common import ATOL, SMALL_HRNET, _nchw, hrnet_weights, no_kernels  # noqa: F401
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu_torch import bench as TB


def test_rssformer_predict_matches_jax(hrnet_weights, no_kernels):
    """Probabilities and their mean of the K5 model (plain K5 on the CPU) against
    the JAX model without the fused FFN; the unfused twin holds the same weights."""
    v, sd = hrnet_weights
    w = TB.build_rssformer_predict("cpu", **SMALL_HRNET)
    w.model.load_state_dict(sd)
    assert all(m.fused for m in w.model.modules() if type(m).__name__ == "MlpDWBN")
    want = np.asarray(JHRNetFusion("hrnetv2_w18", classes=7).apply(v, jnp.asarray(w.inputs["x"])))
    prob = w.run()
    assert prob.shape == (2, 7, 64, 64) and prob.std() > 0.01   # not one-hot
    np.testing.assert_allclose(prob.numpy(), _nchw(want), rtol=0, atol=ATOL)
    assert abs(float(w.call()) - float(want.mean())) <= ATOL
    assert abs(float(w.count()) - float(w.call())) <= 1e-5
