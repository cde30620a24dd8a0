"""`train/checkpoints.py` of the PyTorch port: the `step_N` layout, `latest_step`
and resume into an existing state, as `tests/test_train_infra.py` holds the JAX
package's Orbax version to."""
import os

import pytest
import torch
from torch import nn

from representationlearning_tpu_torch.train import checkpoints as CK
from representationlearning_tpu_torch.train import optim as TO
from representationlearning_tpu_torch.train.state import TrainState

torch.set_num_threads(2)


def _state(seed):
    torch.manual_seed(seed)
    m = nn.Sequential(nn.Conv2d(3, 4, 1), nn.BatchNorm2d(4), nn.Flatten(), nn.LazyLinear(2))
    m(torch.randn(2, 3, 2, 2))
    return TrainState.create(m, TO.make_poly_warmup_adamw(m, 1e-2, 0.01, 2, 10))


def _step(state, seed):
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(seed))
    state.model(x).square().mean().backward()
    return state.apply_gradients()


def test_save_layout_latest_step_and_missing(tmp_path):
    d = str(tmp_path / "ckpt")
    assert CK.latest_step(d) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CK.restore(d, _state(0))
    s = _state(0)
    for _ in range(3):
        _step(s, s.step)
        path = CK.save(d, s.step, s)
    assert path == os.path.join(os.path.abspath(d), "step_3")
    assert sorted(os.listdir(d)) == ["step_1", "step_2", "step_3"]
    os.makedirs(os.path.join(d, "step_9"))      # a save that never finished
    os.makedirs(os.path.join(d, "step_final"))
    assert CK.latest_step(d) == 3


def test_restore_resumes_the_same_trajectory(tmp_path):
    d = str(tmp_path)
    a = _state(0)
    _step(a, 0)
    _step(a, 1)
    CK.save(d, a.step, a)
    b = CK.restore(d, _state(7))   # another initialisation: everything is overwritten
    assert b.step == 2 and b.learning_rates == a.learning_rates
    for (n, u), (_, w) in zip(a.variables.items(), b.variables.items()):
        assert torch.equal(u, w), n   # parameters and BatchNorm statistics
    _step(a, 2)
    _step(b, 2)
    for u, w in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(u, w)      # moments, step count and schedule came along
    assert a.learning_rates == b.learning_rates
    CK.save(d, 1, _state(3))
    assert CK.restore(d, _state(5), step=1).step == 0  # a named step, not the latest
