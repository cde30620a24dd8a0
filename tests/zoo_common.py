"""Shared pieces of the tests that hold the port's baseline zoo
(`representationlearning_tpu_torch/models/{baselines,smp_zoo}.py`) to the JAX
package: the fourteen models on both sides, the JAX variables of a port
state_dict, calmed weights, and the comparisons (eval probabilities, the
training loss dict, the running statistics after it, each top-level module's
gradient norm)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from hrt_common import nchw, nhwc, scoped_variables
from representationlearning_tpu.convert.torch2jax import (convert_hrnet, convert_resnet50,
                                                          state_dict_to_numpy)
from representationlearning_tpu.models import baselines as JB
from representationlearning_tpu.models import smp_zoo as JZ
from representationlearning_tpu_torch.models import baselines as TB
from representationlearning_tpu_torch.models import smp_zoo as TZ

EVAL_TOL, LOSS_RTOL, STATS_TOL, NORM_RTOL, MODULE_TOL = 2e-4, 1e-5, 1e-4, 1e-3, 2e-5
CLASSES = 7
ENCODERS = ("resnet", "encoder")

# name -> (the port's class, the JAX class, constructor keywords on both sides)
ZOO = {
    "FarSegV1": (TB.FarSegV1, JB.FarSegV1, {}),
    "SemanticFPN": (TB.SemanticFPN, JB.SemanticFPN, {}),
    "PSPNet": (TB.PSPNet, JB.PSPNet, {}),
    "FCN8s": (TB.FCN8s, JB.FCN8s, {}),
    "AnyUNet": (TB.AnyUNet, JB.AnyUNet, {}),
    "FactSeg": (TB.FactSeg, JB.FactSeg, {}),
    "SemanticFPNDecouple": (TB.SemanticFPNDecouple, JB.SemanticFPNDecouple,
                            {"label_smooth": 0.1}),
    "UNetPP": (TZ.UNetPP, JZ.UNetPP, {}),
    "LinkNet": (TZ.LinkNet, JZ.LinkNet, {}),
    "DeepLabV3": (TZ.DeepLabV3, JZ.DeepLabV3, {}),
    "DeepLabV3Plus": (TZ.DeepLabV3Plus, JZ.DeepLabV3Plus, {}),
    "MANet": (TZ.MANet, JZ.MANet, {}),
    "PAN": (TZ.PAN, JZ.PAN, {}),
    "trans": (TZ.Trans, JZ.Trans, {"hrnet_type": "hrnetv2_w18"}),
}


def port_model(name, seed=0):
    cls, _, kw = ZOO[name]
    return cls(classes=CLASSES, device="cpu", generator=torch.Generator().manual_seed(seed), **kw)


def jax_model(name):
    _, cls, kw = ZOO[name]
    return cls(classes=CLASSES, **kw)


def _nest(tree, top):
    return {coll: {top: leaves} for coll, leaves in tree.items()}


def zoo_variables(sd) -> dict:
    """A port zoo state_dict -> the JAX model's variables: the ResNet-50 under
    ``resnet`` / ``encoder`` through `convert_resnet50`, the HRNet under
    ``backbone`` through `convert_hrnet`, both strict; flax's PReLU slope (a
    scalar ``negative_slope``) from ``PReLU_<i>.weight``; the rest by JAX's
    scopes."""
    sd = {k: np.array(t) for k, t in state_dict_to_numpy(sd).items()}   # copies
    top = {k.split(".")[0] for k in sd}
    out = {"params": {}, "batch_stats": {}}
    rest = {}
    for k, v in sd.items():
        if k.startswith("PReLU_"):
            out["params"][k.split(".")[0]] = {"negative_slope": v.reshape(())}
        elif not k.startswith(ENCODERS + ("backbone.",)):
            rest[k] = v
    for enc in set(ENCODERS) & top:
        part = {k[len(enc) + 1:]: v for k, v in sd.items()
                if k.startswith(enc + ".") and not k.endswith("num_batches_tracked")}
        for coll, leaves in _nest(convert_resnet50(part, strict=True), enc).items():
            out[coll].update(leaves)
    if "backbone" in top:
        enc = convert_hrnet({k: v for k, v in sd.items() if k.startswith("backbone.")},
                            strict=True, prefix="backbone.")
        for coll in ("params", "batch_stats"):
            out[coll].update(enc.get(coll, {}))
    scoped = scoped_variables({k: torch.from_numpy(v) for k, v in rest.items()})
    for coll, leaves in scoped.items():
        out[coll].update(leaves)
    return out


def calm(model, seed):
    """Noise on every bias, norm affine, PReLU slope and BatchNorm statistic, so
    that their wiring shows, and the BatchNorm scales halved (the ResNet's
    frozen ones too), so that the stream stays of order 1 at random weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.mul_(0.5)
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif name.endswith(("bias", "running_mean")) or t.ndim == 1:   # norms, PReLU
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return model


@contextlib.contextmanager
def flax_dropout_off():
    """flax ``nn.Dropout`` as the identity, for the block only."""
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        yield
    finally:
        fnn.Dropout.__call__ = call


@contextlib.contextmanager
def port_dropout_off():
    """The port's zoo dropout (PSPNet, FCN8s) as the identity, for the block only."""
    plain = TB.dropout
    TB.dropout = lambda x, *a, **k: x
    try:
        yield
    finally:
        TB.dropout = plain


def inputs(seed, batch=1, side=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, side, side, 3)).astype(np.float32)
    y = rng.integers(-1, CLASSES, (batch, side, side)).astype(np.int32)
    return x, y


def jax_reference(name, v, x, y, train=True, jit=True):
    """JAX's eval probabilities and, with ``train``, the training loss dict, the
    mutated statistics and the gradient norm of each top-level module; jitted
    (one compile a model) or eager; flax's dropout the identity."""
    model = jax_model(name)

    def run(v, x, y):
        probs = model.apply(v, x)
        if not train:
            return probs, None

        def loss_fn(params):
            losses, mutated = model.apply({**v, "params": params}, x, y, train=True,
                                          mutable=["batch_stats"])
            return sum(losses.values()), (losses, mutated)

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return probs, (aux, grads)

    with flax_dropout_off():
        probs, rest = (jax.jit(run) if jit else run)(v, jnp.asarray(x), jnp.asarray(y))
    out = dict(probs=np.asarray(probs))
    if train:
        (losses, mutated), grads = rest
        out.update(losses={k: float(l) for k, l in losses.items()},
                   stats=jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]),
                   norms={k: float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                                               for g in jax.tree_util.tree_leaves(sub))))
                          for k, sub in grads.items()})
    return out


def f64_variables(v):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)


def port_run(model, x, y, train=True):
    """The port's side of `jax_reference`: eval probabilities, then one
    training forward, its loss dict, the statistics it leaves, and the gradient
    norm of each top-level module (0 where no gradient reached it)."""
    with torch.no_grad():
        out = dict(probs=nhwc(model.eval()(nchw(x))).astype(x.dtype))
    if not train:
        return out
    losses = model.train()(nchw(x), torch.from_numpy(y).long())
    sum(losses.values()).backward()
    sums = {}
    for k, p in model.named_parameters():
        g = 0.0 if p.grad is None else float(p.grad.double().square().sum())
        sums[k.split(".")[0]] = sums.get(k.split(".")[0], 0.0) + g
    out.update(losses={k: float(v.detach()) for k, v in losses.items()},
               stats=zoo_variables(model.state_dict())["batch_stats"],
               norms={k: s ** 0.5 for k, s in sums.items()})
    return out


def assert_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def assert_matches(got, want):
    """The comparisons and their bounds: eval 2e-4 of max(1, largest), losses
    1e-5 relative, statistics 1e-4 of max(largest, 1e-3), norms 1e-3
    relative; the training ones where ``want`` has them."""
    assert got["probs"].shape == want["probs"].shape
    assert 0.005 < want["probs"].std()           # not a constant map
    assert_close(got["probs"], want["probs"], EVAL_TOL)
    if "losses" not in want:
        return
    assert set(got["losses"]) == set(want["losses"])
    for k, w in want["losses"].items():
        assert np.isfinite(w) and abs(got["losses"][k] - w) <= LOSS_RTOL * abs(w), \
            (k, got["losses"][k], w)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got["stats"])[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want["stats"])[0])
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        err = np.abs(np.asarray(flat_got[k]) - w).max()
        assert err <= STATS_TOL * max(np.abs(w).max(), 1e-3), (k, err)
    assert set(got["norms"]) == set(want["norms"])
    for k, w in want["norms"].items():
        assert abs(got["norms"][k] - w) <= NORM_RTOL * max(w, 1e-12), (k, got["norms"][k], w)


def model_matches_jax(name, f64_train=False, jit=True):
    """A registered zoo model, calmed, against JAX at 2 x 64 x 64: eval in f32;
    the training comparisons in f32, or with ``f64_train`` in f64 on both
    sides; JAX jitted or (``jit=False``) eager."""
    from representationlearning_tpu_torch.core.registry import MODELS

    m = calm(port_model(name), 1)
    assert MODELS.get(name) is type(m)
    x, y = inputs(3, batch=2)
    assert (y == -1).any()
    v = zoo_variables(m.state_dict())
    want = jax_reference(name, v, x, y, train=not f64_train, jit=jit)
    with port_dropout_off():
        got = port_run(m, x, y, train=not f64_train)
    assert_matches(got, want)
    if f64_train:
        with jax.enable_x64(True):
            want = jax_reference(name, f64_variables(v), x.astype(np.float64), y, jit=jit)
        with port_dropout_off():
            got = port_run(m.double(), x.astype(np.float64), y)
        assert_matches(got, want)
    return got


def _to_port(a):
    if isinstance(a, np.ndarray) and a.ndim == 4:
        return nchw(a)
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [nchw(f) for f in a]
    return a


def _to_jax(a):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [jnp.asarray(f) for f in a]
    return a


def _nhwc_all(out):
    return [nhwc(o) for o in out] if isinstance(out, (list, tuple)) else [nhwc(out)]


def block_matches(port, jax_mod, *args, seed=0, train_arg=True):
    """A building block with seeded, calmed weights against the JAX module on
    the same NHWC numpy inputs (lists of maps go as lists; other arguments as
    they are): the output in eval mode and, where the block has BatchNorms, in
    training mode with the running statistics it leaves; 2e-5 of max(1,
    largest) each. ``train_arg``: the JAX module takes ``train``."""
    from representationlearning_tpu_torch.models.layers import init_weights

    init_weights(port, torch.Generator().manual_seed(seed))
    calm(port, seed + 1)
    v = scoped_variables(port.state_dict())
    kw = {"train": False} if train_arg else {}
    want = jax_mod.apply(v, *map(_to_jax, args), **kw)
    with torch.no_grad():
        got = port.eval()(*map(_to_port, args))
    for g, w in zip(_nhwc_all(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == np.shape(w)
        assert_close(g, w, MODULE_TOL)
    if "batch_stats" not in v:
        return got
    want, mutated = jax_mod.apply(v, *map(_to_jax, args), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = port.train()(*map(_to_port, args))
    for g, w in zip(_nhwc_all(got_t), jax.tree_util.tree_leaves(want)):
        assert_close(g, w, MODULE_TOL)
    stats = scoped_variables(port.state_dict())["batch_stats"]
    flat = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    for k, w in jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]:
        assert_close(flat[k], w, MODULE_TOL)
    return got
