"""IRN of the PyTorch port (`models/irn.py`) against the JAX package: `IRNNet`
with and without the mean shift, `edge_displacement_infer`,
`AffinityDisplacementHead.losses` and `irn_total_loss`, within 2e-4 of the
largest magnitude in f32. JAX's variables (initialised, then every BatchNorm,
GroupNorm, bias and the running mean jittered so that their wiring shows) reach
the port through `irn_state_dict_from_jax`, loaded with strict=True; the images
are numpy-seeded, 64 x 96. JAX's side is computed once, in a module-scoped
fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import irn as JI
from representationlearning_tpu.wsss import indexing as JX
from representationlearning_tpu_torch.convert.from_jax import irn_state_dict_from_jax
from representationlearning_tpu_torch.models import irn as TI
from representationlearning_tpu_torch.wsss import indexing as TX

torch.set_num_threads(2)

REL = 2e-4   # f32 end to end, of the largest magnitude
H, W = 64, 96


def _jitter(variables, seed):
    """BatchNorm scales halved (sixteen bottlenecks keep the stream of order 1),
    noise on every statistic, scale and bias, running variances in [0.75, 1.25]."""
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


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _nchw(a):
    return np.array(np.asarray(a).transpose(0, 3, 1, 2))   # a writable copy


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    model = JI.IRNNet()
    v = _jitter(model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 1)
    xj = jnp.asarray(x)
    want = {"plain": model.apply(v, xj), "shift": model.apply(v, xj, apply_mean_shift=True)}
    want["infer"] = JI.edge_displacement_infer(model.apply, v, xj)
    pidx = JX.PathIndex(10, (H // 4, W // 4))
    seg = rng.choice([0, 0, 5, 12, 255], (H // 4, W // 4)).astype(np.uint8)
    labels = [np.stack([a, a]) for a in JX.GetAffinityLabelFromIndices(
        pidx.src_indices, pidx.dst_indices)(seg)]
    head = JI.AffinityDisplacementHead(pidx)
    edge, dp = want["plain"]
    want["losses"] = head.losses(edge, dp)
    want["total"] = JI.irn_total_loss(head, edge, dp, *map(jnp.asarray, labels))
    net = TI.IRNNet(device="cpu").eval()
    net.load_state_dict(irn_state_dict_from_jax(v), strict=True)
    return dict(x=torch.from_numpy(_nchw(x)), v=v, net=net, want=want, labels=labels, seg=seg)


def test_names_are_irn_published_ones(setup):
    names = set(setup["net"].state_dict())
    for k in ("resnet50.conv1.weight", "resnet50.layer4.2.bn3.running_var",
              "fc_edge1.0.weight", "fc_edge3.1.bias", "fc_edge6.weight", "fc_edge6.bias",
              "fc_dp6.1.weight", "fc_dp7.0.weight", "fc_dp7.1.weight", "fc_dp7.3.weight",
              "mean_shift.running_mean"):
        assert k in names, k
    assert setup["net"].fc_dp7[3].weight.shape == (2, 256, 1, 1)
    assert all(m.eps == 1e-6 for m in setup["net"].modules()
               if isinstance(m, torch.nn.GroupNorm))


@pytest.mark.parametrize("shift", ["plain", "shift"])
def test_irnnet_matches_jax(setup, shift):
    with torch.no_grad():
        edge, dp = setup["net"](setup["x"], apply_mean_shift=shift == "shift")
    assert edge.shape == (2, 1, H // 4, W // 4) and dp.shape == (2, 2, H // 4, W // 4)
    we, wd = setup["want"][shift]
    _close(edge, _nchw(we))
    _close(dp, _nchw(wd))


def test_mean_shift_subtracts_the_running_mean(setup):
    mean = setup["net"].mean_shift.running_mean
    np.testing.assert_array_equal(mean.numpy(), np.asarray(
        setup["v"]["batch_stats"]["dp_running_mean"]))
    with torch.no_grad():
        _, plain = setup["net"](setup["x"])
        _, shifted = setup["net"](setup["x"], apply_mean_shift=True)
    assert torch.equal(shifted, plain - mean.view(1, 2, 1, 1))


def test_edge_displacement_infer_matches_jax(setup):
    with torch.no_grad():
        edge, dp = TI.edge_displacement_infer(setup["net"], setup["x"])
    we, wd = setup["want"]["infer"]
    assert edge.shape == (H // 4, W // 4) and dp.shape == (2, H // 4, W // 4)
    _close(edge, we)
    _close(dp, np.asarray(wd).transpose(2, 0, 1))


def test_head_losses_and_total_match_jax(setup):
    pidx = TX.PathIndex(10, (H // 4, W // 4))
    head = TI.AffinityDisplacementHead(pidx)
    we, wd = setup["want"]["plain"]
    got = head.losses(torch.from_numpy(_nchw(we)), torch.from_numpy(_nchw(wd)))
    for g, w in zip(got, setup["want"]["losses"]):
        w = np.asarray(w)
        if w.ndim == 4:   # (B, 2, n_paths, n_pos) maps keep their axes
            assert g.shape == w.shape
        _close(g, w)
    labels = [torch.from_numpy(a) for a in setup["labels"]]
    total, parts = TI.irn_total_loss(head, torch.from_numpy(_nchw(we)),
                                     torch.from_numpy(_nchw(wd)), *labels)
    want_total, want_parts = setup["want"]["total"]
    assert set(parts) == set(want_parts) == {"pos_aff", "neg_aff", "dp_fg", "dp_bg"}
    _close(total, want_total)
    for k in parts:
        _close(parts[k], want_parts[k])


def test_loss_gradient_stops_at_the_backbone(setup):
    """The backbone is detached stage by stage: a loss reaches the heads only."""
    net = TI.IRNNet(device="cpu", generator=torch.Generator().manual_seed(1))
    edge, dp = net(setup["x"][:1, :, :32, :48])
    (edge.sum() + dp.sum()).backward()
    assert all(p.grad is None for p in net.resnet50.parameters())
    assert net.fc_edge6.weight.grad is not None and net.fc_dp7[3].weight.grad is not None


def test_irnnet_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.IRNNet()
    a = TI.IRNNet(device="cpu", generator=torch.Generator().manual_seed(3))
    b = TI.IRNNet(device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
