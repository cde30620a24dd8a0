"""Rank functions of the port's multi-rank tests (`tests/test_torch_parallel.py`,
`test_torch_sliding_sharded.py`, `test_torch_dp_steps.py`, `test_torch_cli_dp.py`).
Each runs in a gloo rank spawned by `parallel/launch.py::spawn_ranks` and returns
numpy arrays or tensors on the CPU. Nothing here imports JAX, so a rank starts
in a few seconds; the tests compute JAX's side in their own process."""
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from representationlearning_tpu_torch.infer import sliding as S
from representationlearning_tpu_torch.models.layers import ConvBNReLU
from representationlearning_tpu_torch.parallel import collectives as C
from representationlearning_tpu_torch.parallel import mesh as M


def collectives_rank(rank, world, x, halo_x, stats_x):
    """pmean_tree / psum_tree of this rank's row of ``x``, halo_exchange_1d of its
    rows of ``halo_x`` (axis 0, halo 1), sync_batch_stats of its rows of
    ``stats_x``, process_local_slice of range(10), and a 2 x 1 mesh's groups."""
    g = dist.group.WORLD
    row = torch.from_numpy(x[rank:rank + 1])
    mine = torch.from_numpy(halo_x.reshape(world, -1, halo_x.shape[-1])[rank])
    part = torch.from_numpy(stats_x.reshape(world, -1, stats_x.shape[-1])[rank])
    mean, var = part.mean(0), part.var(0, unbiased=False)
    grads = {"g": row, "h": [row * 2.0, row.double()]}
    out = {"pmean": C.pmean_tree({"g": row}, g)["g"].numpy(),
           "psum": C.psum_tree(grads, g),
           "halo": C.halo_exchange_1d(mine, 1, 0, g).numpy(),
           "stats": [t.numpy() for t in C.sync_batch_stats(mean, var, g)],
           "local_slice": M.process_local_slice(np.arange(10))}
    mesh = M.make_mesh(world // 2, 2)
    out["mesh"] = (mesh.coords, dist.get_world_size(mesh.data_group),
                   dist.get_world_size(mesh.model_group),
                   M.shard_batch(mesh, {"x": np.arange(2 * world)})["x"])
    gathered = C.all_gather(torch.full((2,), float(rank)), g)
    out["gather"] = torch.stack(gathered).numpy()
    return out


def bn_rank(rank, world, cases):
    """Each case (sd, x NCHW global, cotangent, kernel, relu, axis_name): a
    ``ConvBNReLU`` in training on this rank's rows under the data group; its
    output, input gradient, weight gradients, running statistics and the
    all-reduces of its forward and of its backward."""
    outs, mesh = [], M.make_mesh(world, 1)
    calls = []
    real = dist.all_reduce

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    dist.all_reduce = counting
    for sd, x, cot, kernel, relu, axis_name in cases:
        b = x.shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        m = ConvBNReLU(x.shape[1], sd["conv.weight"].shape[0], kernel, relu,
                       axis_name=axis_name)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        m.train()
        xi = torch.from_numpy(x[rows]).requires_grad_()
        with C.data_parallel(mesh):
            n0 = len(calls)
            y = m(xi)
            n1 = len(calls)
            (y * torch.from_numpy(cot[rows])).sum().backward()
            n2 = len(calls)
            C.allreduce_grads(m.parameters())
        outs.append({"y": y.detach().numpy(), "dx": xi.grad.numpy(),
                     "allreduces": (n1 - n0, n2 - n1),
                     "dw": {n: p.grad.numpy() for n, p in m.named_parameters()},
                     "stats": {k: v.numpy() for k, v in m.state_dict().items()
                               if k.startswith("bn.running")}})
    dist.all_reduce = real
    return outs


def parallel_rank(rank, world, x, halo_x, stats_x, bn_cases):
    return (collectives_rank(rank, world, x, halo_x, stats_x), bn_rank(rank, world, bn_cases))


def conv_mean(n_out):
    """The JAX test's local model: a 3 x 3 mean filter from 3 channels to n_out."""
    w = torch.full((n_out, 3, 3, 3), 1.0 / 9.0)
    return lambda tiles: F.conv2d(tiles, w, padding=1)


def pool_mix(tiles):
    """A model whose every output element is computed the same way whatever the
    batch: a 3 x 3 average and a fixed channel mix, elementwise."""
    y = F.avg_pool2d(tiles, 3, 1, 1)
    return torch.stack([0.5 * y[:, 0] + y[:, 1], y[:, 2] - y[:, 0], y.sum(1)], 1)


def linear_tile(w, window, n_out):
    """The JAX ragged test's model: each window's flat (H, W, C) pixels times w,
    broadcast over the window."""
    w = torch.from_numpy(w)

    def fn(tiles):
        B = tiles.shape[0]
        v = tiles.permute(0, 2, 3, 1).reshape(B, -1) @ w
        return v[:, :, None, None].expand(B, n_out, window, window)
    return fn


def sliding_rank(rank, world, cases):
    """Each case (name, image (C, H, W), window, stride, n_out, model kind, w):
    ``sharded_sliding_window_predict`` over all ranks; and where the kind is
    ``pool_mix``, this rank's rows alone (``gather=False``)."""
    outs, mesh = [], M.make_mesh(1, world)
    for name, image, window, stride, n_out, kind, w in cases:
        fn = {"conv_mean": lambda: conv_mean(n_out), "pool_mix": lambda: pool_mix,
              "linear": lambda: linear_tile(w, window, n_out)}[kind]()
        img = torch.from_numpy(image)
        out = S.sharded_sliding_window_predict(fn, img, mesh, window, stride, n_out)
        rows = None
        if kind == "pool_mix":
            rows = S.sharded_sliding_window_predict(fn, img, mesh, window, stride, n_out,
                                                    gather=False)
        outs.append((name, out, rows))
    return outs


def scd_step_rank(rank, world, sd, x, cls, box, coords, kw, opt):
    """The SCD step of `tests/test_torch_train_scd.py` (eval mode, the CAMs through
    the fused twin, the correlation loss's coordinates given) on this rank's rows
    of the global batch under the data group: the global losses, this rank's
    refined labels, the gradients summed over the ranks and the parameters after
    one AdamW update."""
    from representationlearning_tpu_torch.models.tscd import TSCD, share_parameters
    from representationlearning_tpu_torch.train import optim as TO
    from representationlearning_tpu_torch.train import scd as TS
    from representationlearning_tpu_torch.train.state import TrainState

    m = TSCD("mit_b0", 21, use_flash=True, device="cpu").eval()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    twin = share_parameters(
        TSCD("mit_b0", 21, fused_blocks=True, collect_attns="none", device="cpu"), m).eval()
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    batch = {"image": torch.from_numpy(np.ascontiguousarray(x[rows].transpose(0, 3, 1, 2))),
             "cls_label": torch.from_numpy(cls[rows]), "img_box": torch.from_numpy(box[rows])}
    cfg = TS.SCDConfig(**kw)
    with C.data_parallel(M.make_mesh(world, 1)):
        losses, aux = TS.scd_losses(m, batch, cfg, TS._attn_mask(cfg, "cpu"), cam_model=twin,
                                    coords=tuple(torch.from_numpy(c[rows]) for c in coords))
        total = TS.scd_total_loss(losses, 0, cfg)
        total.backward()
        C.allreduce_grads(m.parameters())
        metrics = C.reduce_metrics({**{k: v.detach() for k, v in losses.items()},
                                    "total": total.detach()})
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    state = TrainState.create(m, TO.make_poly_warmup_adamw(m, param_labels=TO.tscd_param_labels,
                                                           **opt))
    state.apply_gradients()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "refined": aux["refined_label"].numpy(), "grads": grads,
            "after": {n: p.detach().clone() for n, p in m.named_parameters()}}


def cli_rank(rank, world, scd_argv, rss_argv):
    """``cli.train_scd.main(scd_argv)`` on this rank (the TensorBoard mirror off),
    then ``cli.rssformer.main(rss_argv)``, whose ValueError is returned."""
    from representationlearning_tpu_torch.cli import rssformer as RSS
    from representationlearning_tpu_torch.cli import train_scd
    from representationlearning_tpu_torch.utils import events

    events._try_tb_writer = lambda logdir: None
    state = train_scd.main(scd_argv, device="cpu")
    try:
        RSS.main(rss_argv, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"step": state.step, "refused": refused,
            "model": {k: v.clone() for k, v in state.model.state_dict().items()}}
