"""Times K1 `dwconv_gelu` and K5 `mlp_fc1` of the PyTorch port at their main paths' shapes.

With ``--dtype bf16`` (the default), `dwconv_gelu` runs at the four stage geometries of
the headline forward (TSCD / MiT-B1, 8 x 512 x 512, ``chip_smoke.py``; two launches a
stage) and the bf16 `mlp_fc1` at the RSSFormer predict's shape (4 x 16384 tokens of 32
features, hid 128; eight launches a forward). Beside each kernel it prints the one
PyTorch call of (most of) the same work: ``F.conv2d(groups=hid, padding=1)`` with its
bias, without the GELU, on the same plane viewed channels-last, in f32 and in bf16;
``F.linear`` on bf16, without bn1 and the GELU.

With ``--dtype f32`` it times the f32 `mlp_fc1` (3xTF32) at HRNetV2's four widths (dim 18
/ 32 / 40 / 48, hid 4 dim, run at the padded width 96 / 128 / 160 / 192) on 8 x 128^2
tokens, the branch-0 plane of a 512^2 input (``chip_smoke.py`` phase 7l), and at the w32
predict's 4 x 128^2 (eight launches a forward), beside ``F.linear`` in f32 (TF32 off),
without bn1 and the GELU, with a SHA-256 of each output; then a launch at each of phase 7l's
other planes (``FC1_PLANES``) at each width.

Each launch's bound is the larger of its bytes (every argument read once, the output
written once, fc1's at hid rather than the padded width) over 3.35 TB/s and its
operations over their peak (3xTF32 at 494.7 / 3 TFLOP/s in f32), as ``chip_smoke.py``
computes it. Kernels and library calls are timed by replaying a CUDA graph of ten calls
(``chip_smoke.Phases.graph_ms``), so the host's time to launch does not count. With
``--plans`` it also times every plan of the kernels, checks that all give the same bits,
and prints what ``ptxas -v`` said of them. ``--digests`` prints a SHA-256 of the bf16
`mlp_fc1` at each of HRNetV2's widths and each of phase 7l's planes, on inputs drawn by
numpy from a fixed seed (``fc1_bf16_digests``; phase 7l checks the same digests).

Usage, from the root of the repository: ``python tools/time_port_dwconv_fc1.py
[--dtype bf16|f32] [--seed N] [--plans] [--digests] [--label NAME] [--out DIR]``. It
needs a CUDA card and imports no JAX. It also runs on a tree whose wrappers take no plan
(without ``--plans``): copy it into that tree's ``tools/``.
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ptxas_lines(_build, lib: str, kernel: str) -> list[str]:
    """`ptxas -v`'s lines of each instantiation of `kernel` in library `lib`."""
    lines = _build.build_log.get(lib, {}).get("ptxas", "").splitlines()
    return [" | ".join(x.strip() for x in lines[i:i + 4]) for i, a in enumerate(lines)
            if "Compiling entry function" in a and kernel in a]


# the planes of phase 7l's K5 checks (chip_smoke.py `_k5_widths`): the branch-0 plane of a
# 512^2 input, a TTA plane, and the taps kernel's edge planes
FC1_PLANES = ((8, 128, 128), (2, 96, 96), (2, 7, 9), (1, 20, 45), (3, 13, 29), (1, 1, 1))
HRNET_DIMS = (18, 32, 40, 48)


def fc1_inputs(torch, dev, dim: int, hid: int, rng, dtype):
    """w1 (hid, dim) in `dtype`, b1, bn1's scale and shift, drawn by numpy."""
    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dev)

    return (r(hid, dim, scale=dim ** -0.5).to(dtype), r(hid, scale=0.1), r(hid, scale=0.2, shift=1.0),
            r(hid, scale=0.1))


def digest(t) -> str:
    """The first 16 hex digits of a SHA-256 of a tensor's bytes (bf16 read as int16)."""
    import torch

    t = t.detach().cpu()
    return hashlib.sha256((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                          .numpy().tobytes()).hexdigest()[:16]


def fc1_bf16_digests(torch, tm, dev, seed: int = 0) -> dict:
    """{"w<dim> <B>x<H>x<W>": SHA-256} of the bf16 `mlp_fc1` at HRNetV2's widths and
    FC1_PLANES, its inputs drawn by numpy from `seed`: equal digests, equal bits."""
    out = {}
    for dim in HRNET_DIMS:
        rng = np.random.default_rng(seed + dim)
        f1 = fc1_inputs(torch, dev, dim, 4 * dim, rng, torch.bfloat16)
        for B, H, W in FC1_PLANES:
            x = torch.from_numpy(rng.standard_normal((B, H * W, dim)).astype(np.float32)).to(dev)
            with torch.no_grad():
                out[f"w{dim} {B}x{H}x{W}"] = digest(tm.mlp_fc1(x, *f1, dtype=torch.bfloat16))
    return out


def time_fc1_f32(args, torch, cs, ph, tm, res) -> None:
    """The f32 `mlp_fc1` at HRNetV2's four widths on BATCH x 128^2 tokens and at the w32
    predict's RSS_BATCH x 128^2, beside F.linear f32 and the bound."""
    import torch.nn.functional as F

    f32, side = torch.float32, cs.IMAGE // 4
    rate = cs.PEAK_TF32 / 3.0
    plans = args.plans and hasattr(tm, "fc1_f32_tiles")
    rows = []
    for dim, B in [(d, cs.BATCH) for d in HRNET_DIMS] + [(cs.RSS_DIM, cs.RSS_BATCH)]:
        hid = 4 * dim
        rng = np.random.default_rng(args.seed + 100 * B + dim)
        f1 = fc1_inputs(torch, ph.dev, dim, hid, rng, f32)
        x = torch.from_numpy(rng.standard_normal((B, side * side, dim)).astype(np.float32)).to(ph.dev)
        M = B * side * side
        with torch.no_grad():
            h = tm.mlp_fc1(x, *f1, dtype=f32)
            err, _ = cs.max_err(h[..., :hid], tm.mlp_fc1_reference(x, *f1, dtype=f32))
            n_bytes = cs.nbytes(x, f1) + 4 * M * hid
            r = {"dim": dim, "hid": hid, "hp": h.shape[-1], "M": M, "max_abs_err": err,
                 "sha256": digest(h),
                 "ms": ph.graph_ms(lambda: tm.mlp_fc1(x, *f1, dtype=f32)),
                 "library_ms": ph.graph_ms(lambda: F.linear(x, f1[0], f1[1])),
                 "plain_ms": ph.time_ms(lambda: tm.mlp_fc1_reference(x, *f1, dtype=f32), iters=3),
                 "bound_ms": 1e3 * max(n_bytes / cs.PEAK_BYTES, 2.0 * M * dim * hid / rate),
                 "bound_by": "bytes" if n_bytes / cs.PEAK_BYTES >= 2.0 * M * dim * hid / rate
                 else "operations",
                 "plan": tm.fc1_plan(M, dim, hid, f32)}
            if plans:
                r["plans"] = {}
                tiles = tm.fc1_f32_tiles(dim, hid)
                for pl in sorted({(t, n) for t in tiles for n in (1, 33, 66, 99, 132)} | {r["plan"]}):
                    got = tm.mlp_fc1(x, *f1, dtype=f32, plan=pl)
                    r["plans"][str(pl)] = {
                        "ms": ph.graph_ms(lambda: tm.mlp_fc1(x, *f1, dtype=f32, plan=pl)),
                        "equal_bits": bool(torch.equal(got, h))}
        rows.append(r)
        print(f"{args.label}: mlp_fc1 f32 dim {dim} -> hid {hid} (run at {r['hp']}), {B} x {side}², "
              f"M {M}: kernel {r['ms']:.4f} ms, F.linear f32 {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.0%} of it, "
              f"plain {r['plain_ms']:.4f} ms, max abs err {err:.2e}, plan {r['plan']}, SHA-256 "
              f"{r['sha256']}", flush=True)
        for pl, v in r.get("plans", {}).items():
            print(f"    plan {pl}: {1e3 * v['ms']:.2f} us, equal bits {v['equal_bits']}")
        del x, h
    res["mlp_fc1_f32"] = rows
    # a launch at each of phase 7l's other planes, each width
    planes = {}
    for dim in HRNET_DIMS:
        hid = 4 * dim
        rng = np.random.default_rng(args.seed + 7 * dim)
        f1 = fc1_inputs(torch, ph.dev, dim, hid, rng, f32)
        for B, H, W in FC1_PLANES[1:]:
            x = torch.from_numpy(rng.standard_normal((B, H * W, dim)).astype(np.float32)).to(ph.dev)
            with torch.no_grad():
                ms = ph.graph_ms(lambda: tm.mlp_fc1(x, *f1, dtype=f32))
            planes[f"w{dim} {B}x{H}x{W}"] = ms
    res["mlp_fc1_f32_planes_ms"] = planes
    print(f"{args.label}: mlp_fc1 f32 a launch (us) at phase 7l's other planes: "
          + ", ".join(f"{k} {1e3 * v:.2f}" for k, v in planes.items()), flush=True)
    pred = rows[-1]
    n = cs.RSS_BLOCKS
    print(f"{args.label}: mlp_fc1 f32 a w32 predict forward ({n} launches of {cs.RSS_BATCH} x "
          f"{side}²): kernel {n * pred['ms']:.4f} ms, F.linear f32 {n * pred['library_ms']:.4f} ms, "
          f"bound {n * pred['bound_ms']:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import _build
    from representationlearning_tpu_torch.ops import mit_block as tmb
    from representationlearning_tpu_torch.ops import mlp_dwbn as tm

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cs.Phases(torch, args.seed)
    dev, bf16 = ph.dev, torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed)
    plans = args.plans and hasattr(tmb, "dwconv_plan")

    def rand(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(shape, generator=gen) + shift).to(dev)

    res = {"label": args.label, "dtype": args.dtype}
    if args.digests:
        res["fc1_bf16_sha256"] = fc1_bf16_digests(torch, tm, dev, args.seed)
        print(f"{args.label}: mlp_fc1 bf16 SHA-256 at phase 7l's planes: "
              + ", ".join(f"{k} {v}" for k, v in res["fc1_bf16_sha256"].items()), flush=True)
    if args.dtype == "f32":
        time_fc1_f32(args, torch, cs, ph, tm, res)
        if args.plans:
            res["ptxas"] = ptxas_lines(_build, "rssformer", "fc1_wg_kernel")
            for line in res["ptxas"]:
                print(f"  ptxas: {line}")
        return write(args, res)
    res.update({"dwconv_gelu": [], "mlp_fc1": {}})
    total = {"ms": 0.0, "library_ms": 0.0, "library_bf16_ms": 0.0, "bound_ms": 0.0,
             "plain_ms": 0.0}
    for hw, C, _, _, _ in cs.STAGES:
        B, hid = cs.BATCH, 4 * C
        f = rand(B, hw * hw, hid)
        w, b = rand(hid, 1, 3, 3, scale=0.3), rand(hid)
        kw = dict(H=hw, W=hw)
        with torch.no_grad():
            out = tmb.dwconv_gelu(f, w, b, **kw)
            err, _ = cs.max_err(out, tmb.dwconv_gelu_reference(f, w, b, **kw))
            n_bytes = cs.nbytes(f, w, b, out)
            flops, peak = cs.k1_flops("dwconv_gelu", (f, w, b), kw)
            row = {"B": B, "H": hw, "W": hw, "hid": hid, "max_abs_err": err,
                   "ms": ph.graph_ms(lambda: tmb.dwconv_gelu(f, w, b, **kw)),
                   "library_ms": ph.graph_ms(ph._dwconv_library((f, w, b), kw, torch.float32))
                   if hasattr(ph, "_dwconv_library") else None,
                   "library_bf16_ms": ph.graph_ms(ph._dwconv_library((f, w, b), kw, bf16))
                   if hasattr(ph, "_dwconv_library") else None,
                   "plain_ms": ph.time_ms(lambda: tmb.dwconv_gelu_reference(f, w, b, **kw),
                                          iters=3),
                   "bound_ms": 1e3 * max(n_bytes / cs.PEAK_BYTES, flops / peak)}
            if row["library_ms"] is None:   # a parent's chip_smoke.py has no such helper
                x = f.reshape(B, hw, hw, hid).permute(0, 3, 1, 2)
                xb, wb, bb = x.to(bf16), w.to(bf16), b.to(bf16)
                row["library_ms"] = ph.graph_ms(lambda: F.conv2d(x, w, b, padding=1, groups=hid))
                row["library_bf16_ms"] = ph.graph_ms(
                    lambda: F.conv2d(xb, wb, bb, padding=1, groups=hid))
            if hasattr(tmb, "dwconv_plan"):
                row["plan"] = tmb.dwconv_plan(B, hw, hw, hid)
            if plans:
                row["plans"] = {}
                for pl in sorted(set(cs.dwconv_plans(tmb)) | {row["plan"]}):
                    got = tmb.dwconv_gelu(f, w, b, plan=pl, **kw)
                    row["plans"][str(pl)] = {
                        "ms": ph.graph_ms(lambda: tmb.dwconv_gelu(f, w, b, plan=pl, **kw)),
                        "equal_bits": bool(torch.equal(got, out))}
        res["dwconv_gelu"].append(row)
        for key in total:
            total[key] += cs.DEPTH * row[key]
        print(f"{args.label}: dwconv_gelu {hw}x{hw} hid {hid}: kernel {row['ms']:.4f} ms, "
              f"F.conv2d f32 {row['library_ms']:.4f} / bf16 {row['library_bf16_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms, kernel / bound {row['ms'] / row['bound_ms']:.2f}, "
              f"plain {row['plain_ms']:.4f} ms, max abs err {err:.2e}"
              + (f", plan {row['plan']}" if "plan" in row else ""), flush=True)
        for pl, r in row.get("plans", {}).items():
            print(f"    plan {pl}: {1e3 * r['ms']:.2f} us, equal bits {r['equal_bits']}")
        del f, out
    res["dwconv_forward"] = total
    print(f"{args.label}: dwconv_gelu a headline forward ({cs.DEPTH * len(cs.STAGES)} launches): "
          f"kernel {total['ms']:.4f} ms, F.conv2d f32 {total['library_ms']:.4f} ms, bf16 "
          f"{total['library_bf16_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms")

    side, cin, hid = cs.IMAGE // 4, cs.RSS_DIM, 4 * cs.RSS_DIM
    x = rand(cs.RSS_BATCH, side * side, cin)
    f1 = (rand(hid, cin, scale=cin ** -0.5).to(bf16), rand(hid, scale=0.1),
          rand(hid, scale=0.2, shift=1.0), rand(hid, scale=0.1))
    M = x.shape[0] * x.shape[1]
    with torch.no_grad():
        h = tm.mlp_fc1(x, *f1)
        err, _ = cs.max_err(h, tm.mlp_fc1_reference(x, *f1))
        xb, b1 = x.to(bf16), f1[1].to(bf16)
        n_bytes = cs.nbytes(x, f1, h)
        r = {"M": M, "cin": cin, "max_abs_err": err,
             "ms": ph.graph_ms(lambda: tm.mlp_fc1(x, *f1)),
             "library_ms": ph.graph_ms(lambda: F.linear(xb, f1[0], b1)),
             "plain_ms": ph.time_ms(lambda: tm.mlp_fc1_reference(x, *f1), iters=3),
             "bound_ms": 1e3 * max(n_bytes / cs.PEAK_BYTES, 2.0 * M * cin * hid / cs.PEAK_BF16)}
        if hasattr(tm, "fc1_plan"):
            r["plan"] = tm.fc1_plan(M, cin)
        if plans:
            lib = _build.load_library("rssformer")
            r["plans"] = {}
            cands = set(cs.fc1_plans(tm, cin)) | {(4, p) for p in (4, 6, 8)} | {r["plan"]}
            for pl in sorted(cands):
                got = tm.mlp_fc1(x, *f1, plan=pl)
                r["plans"][str(pl)] = {
                    "ms": ph.graph_ms(lambda: tm.mlp_fc1(x, *f1, plan=pl)),
                    "blocks_per_sm": lib.k5_fc1_blocks_per_sm(cin, pl[0]),
                    "equal_bits": bool(torch.equal(got, h))}
    res["mlp_fc1"] = r
    n = cs.RSS_BLOCKS
    print(f"{args.label}: mlp_fc1 M {M} cin {cin}: a launch {r['ms']:.4f} ms, F.linear bf16 "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, kernel / bound "
          f"{r['ms'] / r['bound_ms']:.2f}, plain {r['plain_ms']:.4f} ms, max abs err {err:.2e}"
          + (f", plan {r['plan']}" if "plan" in r else ""))
    print(f"{args.label}: mlp_fc1 a predict forward ({n} launches): kernel {n * r['ms']:.4f} ms, "
          f"F.linear {n * r['library_ms']:.4f} ms, bound {n * r['bound_ms']:.4f} ms")
    for pl, v in r.get("plans", {}).items():
        print(f"    plan {pl}: {1e3 * v['ms']:.2f} us, {v['blocks_per_sm']} blocks an SM, "
              f"equal bits {v['equal_bits']}")
    if plans:
        res["ptxas"] = (ptxas_lines(_build, "mit_block", "dwconv_gelu_kernel")
                        + ptxas_lines(_build, "rssformer", "fc1_kernel"))
        for line in res["ptxas"]:
            print(f"  ptxas: {line}")
    return write(args, res)


def write(args, res) -> int:
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"dwconv_fc1_times_{args.dtype}_{args.label}.json")
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
