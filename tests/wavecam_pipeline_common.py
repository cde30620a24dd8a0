"""Shared pieces of the tests that hold the PyTorch port's WaveCAM pipeline
(`representationlearning_tpu_torch/wsss/wavecam_pipeline.py`) to the JAX
package's: the JAX tests' tiny configuration, the calming of initial weights,
the recording of JAX's initial variables, and the state-dict comparison."""
import os

import jax
import numpy as np

from representationlearning_tpu_torch.wsss import wavecam_pipeline as TP

# tests/test_wavecam_pipeline.py's configuration: 5 classes, 8 synthetic images of
# 48², crop 48, batch 4, one epoch, IRN radius 3, two squarings of the walk
TINY = dict(n_classes=5, crop_size=48, cam_scales=(1.0, 0.5), cam_batch_size=4, cam_epochs=1,
            cam_lr=0.005, wavecam_lr=0.005, irn_lr=0.005, wavecam_epochs=1, irn_crop_size=48,
            irn_batch_size=4, irn_epochs=1, irn_radius=3.0, rw_radius=3, exp_times=2,
            synthetic_n=8, synthetic_size=(48, 48))


def calm(variables, seed):
    """The ResNet's BatchNorm scales halved and noise on every statistic, scale and
    bias (tests/test_torch_irn.py's jitter). At JAX's own initial weights the
    stream grows through the sixteen bottlenecks to logits in the hundreds, and
    f32 rounding then moves the first updates by 1e-3 of themselves; and a bias
    that starts at 0 carries nothing but its updates."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if name == "scale":
            factor = 0.5 if path[-2].key.startswith(("bn", "downsample_bn")) else 1.0
            return (a * factor + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "mean", "dp_running_mean"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def recorder(cls, store, key, seed=None, replay=None):
    """``cls`` whose ``init`` returns its variables (calmed with ``seed``), or
    ``replay``, and keeps them in ``store[key]``: put in the JAX pipeline's module,
    it starts a stage from known weights."""
    class Recording(cls):
        def init(self, *args, **kwargs):
            v = jax.tree_util.tree_map(np.asarray, super().init(*args, **kwargs))
            store[key] = replay if replay is not None else v if seed is None else calm(v, seed)
            return store[key]

    Recording.__name__ = cls.__name__
    return Recording


def port(work_dir, **kw):
    return TP.WaveCAMPipeline(TP.WaveCAMConfig(work_dir=str(work_dir), **{**TINY, **kw}),
                              device="cpu")


def save_weights(pipe, name, obj):
    np.save(os.path.join(pipe.cfg.dir("weights"), name), obj, allow_pickle=True)


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def hold(got: dict, want: dict, tol, label):
    """Every entry of two state dicts within ``tol`` of the entry's largest
    magnitude (the step counts of the port's BatchNorms, which JAX does not keep,
    aside). Prints the worst, for the record."""
    keys = {k for k in want if not k.endswith("num_batches_tracked")}
    assert keys == {k for k in got if not k.endswith("num_batches_tracked")}
    worst = 0.0
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        err = np.abs(g.astype(np.float64) - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (k, err)
        worst = max(worst, err)
    print(f"{label}: worst {worst:.3g} of the largest")
