"""Times K5 `mlp_taps` of the PyTorch port at the RSSFormer predict's shape and the TTA's.

`mlp_taps` (the 19-tap implicit GEMM with bias + bn2 + GELU, fc2, bn3 + GELU) runs at
the predict's shape (4 x 128 x 128 tokens, hid 128, 32 out; eight launches a
forward), at the 8 x 128 x 128 tokens of a 512² branch-0 plane (HRNetFusion's eval at
batch 8), and at the TTA's planes (`infer/tta.py::default_tta_config`: batch 2, 64 to
224 a side); ``--hid`` sets HRNetV2's hidden width (72 / 128 / 160 / 192, cout hid / 4;
the kernel runs at `padded_hid`), ``--dtype`` the operand type (bf16, the default, or
f32: the 3xTF32 `wgmma` kernel). There is no one PyTorch call of the same work. Beside
each launch it prints its bound, the larger of its bytes (every argument read once, the
output written once) over 3.35 TB/s and its operations (the in-plane taps and fc2) over
989 TFLOP/s (bf16) or 494.7 / 3 TFLOP/s (f32), as ``chip_smoke.py`` computes it, and
the bytes a launch moves from L2 into shared memory: the rows of A (a row of the padded
width a tap: the kernel copies every row shifted by a tap that lies in [0, M) and masks
what lies outside the plane) and the 19 tap matrices once a tile of tokens, the number
that says whether the ring or the traffic binds. Launches are timed by replaying a CUDA graph of ten calls
(``chip_smoke.Phases.graph_ms``), so the host's time to launch does not count. With
``--plans`` it also times every plan at every shape, checks that all give the same
bits, and prints what ``ptxas -v`` said of the kernel's instantiations.

Usage, from the root of the repository: ``python tools/time_port_taps.py [--dtype
f32|bf16] [--hid 72|128|160|192] [--seed N] [--plans] [--label NAME] [--out DIR]``. It
needs a CUDA card and imports no JAX. It also runs on a tree whose `taps_tiles` takes no
operand type (without ``--plans``).
"""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def in_plane_taps(tm, B: int, H: int, W: int) -> int:
    """(token, tap) pairs whose source lies inside the plane."""
    return B * sum(max(0, H - abs(dy)) * max(0, W - abs(dx)) for dy, dx in tm.tap_offsets())


def shifted_rows(B: int, H: int, W: int, tile: int, offsets) -> int:
    """(row, tap) pairs of the tiles whose row shifted by the tap lies in [0, M)."""
    M = B * H * W
    rows = math.ceil(M / tile) * tile
    return sum(max(0, min(rows, M - s) - max(0, -s)) for s in (dy * W + dx for dy, dx in offsets))


def l2_bytes(tm, B: int, H: int, W: int, tile: int, hp: int, size: int) -> tuple[int, int]:
    """(A, B) bytes a launch copies from L2 into shared memory at that tile: every row
    shifted by a tap that lies in [0, M) (what lies outside the plane is masked), and
    the 19 tap matrices at the padded width `hp` once a tile, `size` bytes an element."""
    a_rows = shifted_rows(B, H, W, tile, tm.tap_offsets())
    return size * hp * a_rows, math.ceil(B * H * W / tile) * 19 * hp * hp * size


def ptxas_lines(_build, lib: str, kernel: str) -> list[str]:
    """`ptxas -v`'s lines of each instantiation of `kernel` in library `lib`."""
    lines = _build.build_log.get(lib, {}).get("ptxas", "").splitlines()
    return [" | ".join(x.strip() for x in lines[i:i + 4]) for i, a in enumerate(lines)
            if "Compiling entry function" in a and kernel in a]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--hid", type=int, choices=(72, 128, 160, 192), default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import _build
    from representationlearning_tpu_torch.ops import mlp_dwbn as tm

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cs.Phases(torch, args.seed)
    dev = ph.dev
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    size, peak = (4, cs.PEAK_TF32 / 3.0) if args.dtype == "f32" else (2, cs.PEAK_BF16)
    gen = torch.Generator().manual_seed(args.seed)
    plans = args.plans
    hid, n = args.hid, cs.RSS_BLOCKS
    cout, hp = hid // 4, tm.padded_hid(hid)
    tag = f"{args.label} {args.dtype} hid {hid}"

    def rand(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(shape, generator=gen) + shift).to(dev)

    rest = (rand(19, hid, hid, scale=0.03).to(dtype), rand(hid, scale=0.1),
            rand(hid, scale=0.2, shift=1.0), rand(hid, scale=0.1),
            rand(cout, hid, scale=hid ** -0.5).to(dtype), rand(cout, scale=0.1),
            rand(cout, scale=0.2, shift=1.0), rand(cout, scale=0.1))
    side = cs.IMAGE // 4
    shapes = [(cs.RSS_BATCH, side, side), (cs.BATCH, side, side)] \
        + [(2, s, s) for s in (64, 96, 128, 160, 192, 224)]
    res = {"label": args.label, "dtype": args.dtype, "hid": hid, "mlp_taps": []}
    if plans:
        lib = _build.load_library("rssformer")
        res["blocks_per_sm"] = {t: lib.k5_taps_blocks_per_sm(hp, int(size == 4), t)
                                for t in tm.taps_tiles(hid, dtype)}
        print(f"blocks an SM holds of each tile: {res['blocks_per_sm']}")
    for B, H, W in shapes:
        M = B * H * W
        # the hidden plane as `mlp_fc1` leaves it: the padded width, its padding 0
        h = torch.zeros(B, H * W, hp, device=dev, dtype=dtype)
        h[..., :hid] = (0.5 * torch.randn(B, H * W, hid, generator=gen)).to(dev, dtype)
        with torch.no_grad():
            out = tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype)
            err, _ = cs.max_err(out, tm.mlp_taps_reference(h[..., :hid], *rest, H=H, W=W,
                                                           dtype=dtype))
            n_bytes = cs.nbytes(h[..., :hid], rest, out)
            flops = 2.0 * hid * (hid * in_plane_taps(tm, B, H, W) + M * cout)
            plan = tm.taps_plan(B, H, W, cout, hid, dtype)
            a_bytes, b_bytes = l2_bytes(tm, B, H, W, plan[0], hp, size)
            row = {"B": B, "H": H, "W": W, "cout": cout, "plan": plan, "max_abs_err": err,
                   "ms": ph.graph_ms(lambda: tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype)),
                   "bound_ms": 1e3 * max(n_bytes / cs.PEAK_BYTES, flops / peak),
                   "l2_a_bytes": a_bytes, "l2_b_bytes": b_bytes}
            if (B, H, W) == shapes[0]:
                hh = h[..., :hid].contiguous()
                row["plain_ms"] = ph.time_ms(
                    lambda: tm.mlp_taps_reference(hh, *rest, H=H, W=W, dtype=dtype), iters=3)
            if plans:
                row["plans"] = {}
                for pl in cs.taps_plans(tm, B, H, W, hid, dtype):
                    got = tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype, plan=pl)
                    a, b = l2_bytes(tm, B, H, W, pl[0], hp, size)
                    row["plans"][str(pl)] = {
                        "ms": ph.graph_ms(lambda: tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype,
                                                              plan=pl)),
                        "l2_bytes": a + b, "equal_bits": bool(torch.equal(got, out))}
        res["mlp_taps"].append(row)
        l2 = a_bytes + b_bytes
        print(f"{tag}: mlp_taps B {B} {H}x{W}: a launch {1e3 * row['ms']:.2f} us, bound "
              f"{1e3 * row['bound_ms']:.2f} us, kernel / bound {row['ms'] / row['bound_ms']:.2f}, "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, L2 -> shared {l2 / 1e6:.1f} MB (A "
              f"{a_bytes / 1e6:.1f} + B {b_bytes / 1e6:.1f}) = {l2 / row['ms'] / 1e9:.2f} TB/s, "
              f"max abs err {err:.2e}, plan {plan}"
              + (f", plain {row['plain_ms']:.3f} ms" if "plain_ms" in row else ""), flush=True)
        if (B, H, W) == shapes[0]:
            print(f"{tag}: mlp_taps a predict forward ({n} launches): kernel "
                  f"{n * row['ms']:.4f} ms, bound {n * row['bound_ms']:.4f} ms, plain "
                  f"{n * row['plain_ms']:.3f} ms")
        for pl, v in row.get("plans", {}).items():
            print(f"    plan {pl}: {1e3 * v['ms']:.2f} us, L2 -> shared {v['l2_bytes'] / 1e6:.1f} "
                  f"MB, equal bits {v['equal_bits']}")
        del h, out
    if plans:
        res["ptxas"] = ptxas_lines(_build, "rssformer", "taps_")
        for line in res["ptxas"]:
            print(f"  ptxas: {line}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"taps_times_{args.dtype}_{hid}_{args.label}.json")
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
