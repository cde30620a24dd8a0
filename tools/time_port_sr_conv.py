"""Times K1 `sr_conv` of the PyTorch port at the headline forward's and the CAM forwards' shapes.

The headline forward (TSCD / MiT-B1, 8 x 512 x 512, ``chip_smoke.py``) launches `sr_conv`
once in each block of stages 1-3, two blocks a stage: tokens 128² / 64² / 32², C 64 / 128 /
320, sr 8 / 4 / 2, M = 2,048 patch rows at every stage. The WSSS command lines' CAM forwards
(``configs/scd_voc.yaml``: crop 320, scales 0.5 / 1.0 / 1.5 over [x; flip x] at batch 2) reach
M = 100 / 400 / 900 rows at each of the three stages (B = 4; 5, 10 and 15 patches a side),
their validation (96 x 128 images, one or two a call) M = 12 and 24 (3 x 4 patches an image).
For each launch this prints the kernel's time, its bound and the time of ``F.conv2d`` on the
same normalised tokens in the operand type (TF32 off: the library call that computes the
same product; it leaves out the LayerNorm the kernel applies). The bound is the larger of the
launch's bytes (tokens, statistics, weights and vectors read once, the output written once)
over 3.35 TB/s and its operations (2 M K C) over 989 TFLOP/s (bf16) or, as three TF32
products each, over 494.7 TFLOP/s (f32), as ``chip_smoke.py`` computes it. Times are taken by
replaying a CUDA graph of ten calls (``chip_smoke.Phases.graph_ms``), so the host's time to
launch does not count; the headline sum is per forward (x 2 blocks a stage). Beside each
launch it prints the plan and the first 16 hex digits of the SHA-256 of its output, so that
two trees are compared bit for bit. ``--dtype f32`` (the default) times the f32 operand path,
``--dtype bf16`` the bf16 one. With ``--plans`` it also times every plan of the f32 kernel
(64 and 128 rows a tile, every column width up to ``sr_conv_columns(C)``, 1 to 16 K slices a
cluster; its error against the plain version, and whether the card holds its clusters in one
wave); without it the script also runs on a tree whose wrapper takes no f32 plan.

Usage, from the root of the repository: ``python tools/time_port_sr_conv.py [--dtype f32|bf16]
[--seed N] [--plans] [--label NAME] [--out DIR]``. It needs a CUDA card and imports no JAX.
"""
import argparse
import hashlib
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (tokens a side, C, sr) of stages 1-3 at the headline's 512²; for the CAM forwards, the
# patches a side at crop 320 x scales 0.5, 1.0, 1.5; for the validation, the patches of a 96 x
# 128 image (3 x 4 at every stage) and the images a call
STAGES = [(128, 64, 8), (64, 128, 4), (32, 320, 2)]
CAM_PATCHES, CAM_BATCH = (5, 10, 15), 4
VAL_PATCHES, VAL_BATCHES = (3, 4), (1, 2)


def launches(cs):
    """(label, B, tokens down, tokens across, C, sr, counts in the headline forward) of every
    timed launch."""
    out = [(f"headline stage {i}", cs.BATCH, hw, hw, C, sr, True)
           for i, (hw, C, sr) in enumerate(STAGES, start=1)]
    out += [(f"CAM M {CAM_BATCH * p * p} stage {i}", CAM_BATCH, p * sr, p * sr, C, sr, False)
            for p in CAM_PATCHES for i, (_, C, sr) in enumerate(STAGES, start=1)]
    ph, pw = VAL_PATCHES
    out += [(f"val M {B * ph * pw} stage {i}", B, ph * sr, pw * sr, C, sr, False)
            for B in VAL_BATCHES for i, (_, C, sr) in enumerate(STAGES, start=1)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="f32")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import mit_block as tmb

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cs.Phases(torch, args.seed)
    dev = ph.dev
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed)

    rows = []
    for label, B, H, W, C, sr, headline in launches(cs):
        x = (2.0 * torch.randn(B, H * W, C, generator=gen) + 0.5).to(dev)
        K = sr * sr * C
        a = (x, tmb.ln_stats_reference(x), (torch.randn(C, generator=gen) + 1.0).to(dev),
             (0.1 * torch.randn(C, generator=gen)).to(dev),
             (K ** -0.5 * torch.randn(C, K, generator=gen)).to(dev).to(dtype),
             torch.randn(C, generator=gen).to(dev))
        kw = {"H": H, "W": W, "sr": sr, "dtype": dtype}
        got = tmb.sr_conv(*a, **kw)
        want = tmb.sr_conv_reference(*a, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        flops, peak = cs.k1_flops("sr_conv", a, kw)
        if dtype == torch.float32:   # three TF32 products each
            flops, peak = 3.0 * flops, cs.PEAK_TF32
        t_bytes = 1e3 * cs.nbytes(a, got) / cs.PEAK_BYTES
        t_ops = 1e3 * flops / peak
        k_ms = ph.graph_ms(lambda: tmb.sr_conv(*a, **kw))
        lib = ph._library_call("sr_conv", a, kw, dtype)
        lib_ms = ph.graph_ms(lib)
        M = B * (H // sr) * (W // sr)
        row = {"label": label, "B": B, "tokens": [H, W], "C": C, "sr": sr, "M": M, "K": K,
               "headline": headline, "ms": k_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
               "max_abs_err": err, "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        if dtype == torch.float32 and hasattr(tmb, "check_sr_conv_plan"):
            row["plan"] = tmb.sr_conv_plan(M, C, K, dtype)
        if args.plans and "plan" in row:
            row["plans"] = {}
            for rows_, cols in [(r, c) for r in tmb.SR_WG_ROWS for c in tmb.SR_WG_COLUMNS
                                if c <= tmb.sr_conv_columns(C)]:
                tiles = math.ceil(M / rows_) * math.ceil(C / cols)
                for s in tmb.sr_conv_slice_counts(K, dtype):
                    p = ((rows_, cols), s)
                    again = tmb.sr_conv(*a, plan=p, **kw)
                    row["plans"][str(p)] = {
                        "ms": ph.graph_ms(lambda: tmb.sr_conv(*a, plan=p, **kw)),
                        "max_abs_err": (again - want).abs().max().item(),
                        "one_wave": tiles <= tmb.SR_WG_CLUSTERS[s - 1]}
        rows.append(row)
        print(f"{args.label} {args.dtype}: {label:22s} M {M:5d} K {K:4d} C {C:3d}: kernel "
              f"{k_ms * 1e3:8.2f} us, bound {row['bound_ms'] * 1e3:6.2f} us ({row['bound_by']}; "
              f"kernel / bound {k_ms / row['bound_ms']:.2f}), F.conv2d {lib_ms * 1e3:8.2f} us, max abs "
              f"err {err:.2e}, SHA-256 {row['sha256']}"
              + (f", plan {row['plan']}" if "plan" in row else ""), flush=True)
        if "plans" in row:
            best = sorted(row["plans"].items(), key=lambda kv: kv[1]["ms"])
            print("    plans, fastest first: " + ", ".join(
                f"{p} {v['ms'] * 1e3:.2f}{'' if v['one_wave'] else ' (two waves)'}" for p, v in best))
        del x, a, got, want
    head = [r for r in rows if r["headline"]]
    total = {"ms": cs.DEPTH * sum(r["ms"] for r in head),
             "bound_ms": cs.DEPTH * sum(r["bound_ms"] for r in head),
             "library_ms": cs.DEPTH * sum(r["library_ms"] for r in head)}
    print(f"{args.label} {args.dtype}: a headline forward, {cs.DEPTH * len(head)} launches: kernel "
          f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms ({total['bound_ms'] / total['ms']:.0%} "
          f"of it), F.conv2d {total['library_ms']:.4f} ms")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"sr_conv_times_{args.dtype}_{args.label}.json")
        with open(path, "w") as f:
            json.dump({"launches": rows, "forward": total}, f, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
