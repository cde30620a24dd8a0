"""Training mode of the port's modules: drop path and dropout from an explicit
generator, gradient checkpointing with the same masks, the SegFormer head's
BatchNorm batch statistics and running-average update against the JAX head with
`train=True`, and `cam_only`'s detached CAM."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.segformer_head import SegFormerHead as JHead
from representationlearning_tpu_torch.convert.from_jax import state_dict_from_jax
from representationlearning_tpu_torch.models import layers
from representationlearning_tpu_torch.models.mit import make_mit
from representationlearning_tpu_torch.models.segformer_head import SegFormerHead
from representationlearning_tpu_torch.models.tscd import TSCD, share_parameters

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_drop_path_draws_from_its_generator():
    dp = layers.DropPath(0.3).train()
    x = torch.ones(4096, 2, 3)
    a, b, c = dp(x, generator=_gen(0)), dp(x, generator=_gen(0)), dp(x, generator=_gen(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a[:, 0, 0] != 0)
    assert torch.equal(a[kept], x[kept] / 0.7) and (a[~kept] == 0).all()
    # Bernoulli(keep = 0.7) per sample, as `jax.random.bernoulli(rng, keep)`: 4 sigma
    assert abs(kept.float().mean().item() - 0.7) < 4 * (0.7 * 0.3 / 4096) ** 0.5
    mask = dp.draw(4096, "cpu", _gen(0))
    assert mask.dtype == torch.bool and torch.equal(mask, kept)
    assert torch.equal(dp(x, mask=mask), a)
    assert dp.eval().draw(8, "cpu") is None and layers.DropPath(0.0).train().draw(8, "cpu") is None


def test_dropout_is_elementwise_scaled_and_seeded():
    x = torch.ones(64, 8, 16, 16)
    a = layers.dropout(x, 0.1, True, _gen(0))
    assert torch.equal(a, layers.dropout(x, 0.1, True, _gen(0)))
    assert not torch.equal(a, layers.dropout(x, 0.1, True, _gen(1)))
    assert a.unique().tolist() == pytest.approx([0.0, 1 / 0.9])
    assert abs((a == 0).float().mean().item() - 0.1) < 5e-3
    per_map = (a == 0).float().mean(dim=(2, 3))
    assert 0 < per_map.min() and per_map.max() < 1   # elementwise, not whole maps
    assert layers.dropout(x, 0.1, False, _gen(0)) is x and layers.dropout(x, 0.0, True) is x
    torch.manual_seed(0)
    g = layers.dropout(x, 0.5, True)
    assert abs((g == 0).float().mean().item() - 0.5) < 5e-3


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_training_forward_is_seeded_and_remat_keeps_the_masks(use_flash):
    kw = dict(drop_path_rate=0.5, use_flash=use_flash)
    enc = make_mit("mit_b0", **kw).train()
    layers.init_weights(enc, _gen(0))
    rem = make_mit("mit_b0", remat=True, **kw).train()
    rem.load_state_dict(enc.state_dict())
    x = torch.randn(4, 3, 64, 64, generator=_gen(1))

    def run(m, seed):
        m.zero_grad()
        feats, attns = m(x, _gen(seed))
        loss = sum(f.square().mean() for f in feats) + sum(a.square().mean() for a in attns)
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in m.parameters()]

    l0, g0 = run(enc, 0)
    l0b, _ = run(enc, 0)
    l1, _ = run(enc, 1)
    assert torch.equal(l0, l0b) and not torch.equal(l0, l1)
    # recomputing a block in the backward pass sees the masks of its forward
    lr, gr = run(rem, 0)
    assert torch.equal(l0, lr)
    for a, b in zip(g0, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    enc.eval()
    with torch.no_grad():
        assert torch.equal(enc(x, _gen(0))[0][3], enc(x, _gen(5))[0][3])


def test_head_batch_statistics_and_running_average_match_flax():
    """`train=True` with the dropout off (the two libraries' draws cannot agree):
    normalisation by batch statistics, and the running average moved by flax
    momentum 0.9 = torch momentum 0.1 towards the BIASED batch variance."""
    rng = np.random.default_rng(0)
    dims, sizes = (32, 64, 160, 256), (16, 8, 4, 4)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32) for c, s in zip(dims, sizes)]
    jh = JHead(num_classes=6, embedding_dim=32, dropout_rate=0.0)
    jf = [jnp.asarray(f) for f in feats]
    v = jh.init(jax.random.PRNGKey(0), jf)
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: a + 0.5, v["batch_stats"])}
    want, mutated = jh.apply(v, jf, train=True, mutable=["batch_stats"])
    th = SegFormerHead(dims, 6, 32, dropout_rate=0.0).train()
    # under the scope it has in TSCD, where the converter knows its Linear layers
    sd = state_dict_from_jax({k: {"decoder": jax.tree_util.tree_map(np.asarray, t)}
                              for k, t in v.items()})
    th.load_state_dict({k.removeprefix("decoder."): t for k, t in sd.items()})
    tf = [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))) for f in feats]
    got = th(tf)
    # f32, sums over 512 positions and 128 channels in another order
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=2e-5)
    bs = mutated["batch_stats"]["linear_fuse"]["bn"]
    bn = th.linear_fuse.bn
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(bs["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(bs["var"]), rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    # inside bn_stats_frozen: batch statistics still, the running ones untouched
    before = bn.running_var.clone()
    with layers.bn_stats_frozen(th):
        again = th(tf)
    assert torch.equal(again, got) and torch.equal(bn.running_var, before)
    assert bn.track_stats
    # eval normalises with the running statistics, as `train=False`
    want_eval = jh.apply({"params": v["params"], "batch_stats": mutated["batch_stats"]}, jf)
    np.testing.assert_allclose(th.eval()(tf).detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_eval), atol=2e-5)


def test_tscd_training_forward_cam_only_and_shared_twin():
    m = TSCD("mit_b0", 6, device="cpu", generator=_gen(0)).train()
    x = torch.randn(2, 3, 64, 64, generator=_gen(1))
    a, b, c = m(x, generator=_gen(0)), m(x, generator=_gen(0)), m(x, generator=_gen(1))
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])   # drop path and dropout
    cam, pred = m(x, cam_only=True, generator=_gen(0))
    assert not cam.requires_grad and pred.requires_grad          # JAX `models/tscd.py:87`
    twin = share_parameters(
        TSCD("mit_b0", 6, device="cpu", fused_blocks=True, collect_attns="none"), m).eval()
    assert all(p is dict(m.named_parameters())[n] for n, p in twin.named_parameters())
    assert twin.decoder.linear_fuse.bn.running_mean is m.decoder.linear_fuse.bn.running_mean
    with torch.no_grad():
        want = m.eval()(x, cam_only=True)[0]
        np.testing.assert_allclose(twin(x, cam_only=True)[0].numpy(), want.numpy(), atol=1e-4)
        m.classifier.weight.mul_(2.0)   # an update of the trained model reaches the twin
        np.testing.assert_allclose(twin(x, cam_only=True)[0].numpy(), 2 * want.numpy(), atol=2e-4)
