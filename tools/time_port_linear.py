"""Times K1 `linear` of the PyTorch port at every launch of the headline forward.

The headline forward (TSCD / MiT-B1, 8 x 512 x 512, ``chip_smoke.py``) launches
`linear` five times a block: q (LayerNorm prologue), kv (LayerNorm prologue, on
the sr-reduced tokens), proj (+ residual), fc1 (LayerNorm prologue) and fc2 (+
residual), two blocks a stage. For each of the twenty launch geometries this
prints the kernel's time, that of ``F.linear`` on the same inputs cast to the operand
type beforehand (the product and the bias only; f32 with TF32 off), and the launch's
bound: the larger of its bytes (every argument read once, the output written once) over
3.35 TB/s and its operations over 989 TFLOP/s (bf16) or over 494.7 / 3 TFLOP/s (f32:
three TF32 products each), as ``chip_smoke.py`` computes it, and beside it the bound of
the same launch with A read and the result written in bf16. Both times are
taken by replaying a CUDA graph of ten calls (``chip_smoke.Phases.graph_ms``), so
the host's time to launch does not count. The sums are per forward (x 2 blocks a
stage). With ``--plans`` it also times, at each geometry, every tile of the kernel
walking 1, 2, 4 and 8 M tiles a block (bf16) or with 1, 3, 33 and 132 persistent blocks
(f32), and the plan of ``linear_plan``; all give equal bits. ``--dtype f32`` times the
f32 operand path (the 3xTF32 `wgmma` kernel; weights f32), ``--dtype bf16`` (the default)
the bf16 one; both run on a tree whose wrapper has no f32 plan too (without ``--plans``).

Usage, from the root of the repository: ``python tools/time_port_linear.py
[--dtype f32|bf16] [--seed N] [--plans] [--label NAME] [--out DIR]``. It needs a CUDA
card and imports no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launches(cs):
    """(stage, name, M, Nout, K, LayerNorm, residual) of the linears of one block of
    each stage of the headline forward."""
    out = []
    for i, (hw, C, _, sr, _) in enumerate(cs.STAGES, start=1):
        M, Mk = cs.BATCH * hw * hw, cs.BATCH * (hw // sr) ** 2
        out += [(i, "q", M, C, C, True, False), (i, "kv", Mk, 2 * C, C, True, False),
                (i, "proj", M, C, C, False, True), (i, "fc1", M, 4 * C, C, True, False),
                (i, "fc2", M, C, 4 * C, False, True)]
    return out


def plans(tmb, M, Nout, K, dtype):
    """bf16: (tile, per) of every tile with 1, 2, 4 and 8 M tiles a block that the grid
    takes; f32: (tile, blocks) of every tile with 1, 3, 33 and 132 persistent blocks; and
    `linear_plan`'s."""
    import torch

    if dtype == torch.float32:
        return sorted({(tile, n) for tile in tmb.linear_tiles(dtype) for n in (1, 3, 33, 132)}
                      | {tmb.linear_plan(M, Nout, K, dtype)})
    out = set()
    for tile in tmb.LINEAR_TILES:
        mtiles = -(-M // tile[0])
        out |= {(tile, per) for per in (1, 2, 4, 8)
                if mtiles >= per and -(-mtiles // per) <= tmb.LINEAR_MAX_GROUPS}
    out.add(tmb.linear_plan(M, Nout, K))
    return sorted(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import mit_block as tmb

    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    ph = cs.Phases(torch, args.seed)
    dev, bf16 = ph.dev, torch.bfloat16
    dtype = torch.float32 if args.dtype == "f32" else bf16
    peak = cs.PEAK_TF32 / 3.0 if dtype == torch.float32 else cs.PEAK_BF16
    gen = torch.Generator().manual_seed(args.seed)

    def rand(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(shape, generator=gen) + shift).to(dev)

    rows, total = [], {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bound_bf16_io_ms": 0.0}
    for stage, name, M, Nout, K, ln, res in launches(cs):
        a = rand(M, K)
        w, bias = rand(Nout, K, scale=0.05).to(dtype), rand(Nout)
        kw = {"dtype": dtype}
        if ln:
            kw.update(stats=tmb.ln_stats(a), ln_w=rand(K, shift=1.0), ln_b=rand(K, scale=0.1))
        if res:
            kw["residual"] = rand(M, Nout)
        out = tmb.linear(a, w, bias, **kw)
        err = (out - tmb.linear_reference(a, w, bias, **kw)).abs().max().item()
        flops = 2.0 * M * Nout * K
        n_bytes = cs.nbytes(a, w, bias, kw, out)
        bound = 1e3 * max(n_bytes / cs.PEAK_BYTES, flops / peak)
        # the same launch with A read and the result written in bf16
        bound_bf16 = 1e3 * max((n_bytes - 2 * M * (K + Nout)) / cs.PEAK_BYTES, flops / peak)
        k_ms = ph.graph_ms(lambda: tmb.linear(a, w, bias, **kw))
        ab, bb = a.to(dtype), bias.to(dtype)
        lib_ms = ph.graph_ms(lambda: F.linear(ab, w, bb))
        row = {"stage": stage, "name": name, "M": M, "Nout": Nout, "K": K, "ms": k_ms,
               "library_ms": lib_ms, "bound_ms": bound, "bound_bf16_io_ms": bound_bf16,
               "max_abs_err": err}
        if hasattr(tmb, "linear_tiles"):   # a tree without the f32 plan times it too
            row["plan"] = tmb.linear_plan(M, Nout, K, dtype)
        if args.plans:
            row["plans"] = {}
            for p in plans(tmb, M, Nout, K, dtype):
                same = torch.equal(tmb.linear(a, w, bias, plan=p, **kw), out)
                row["plans"][str(p)] = {"ms": ph.graph_ms(lambda: tmb.linear(a, w, bias, plan=p, **kw)),
                                        "equal_bits": bool(same)}
        rows.append(row)
        for key in total:
            total[key] += cs.DEPTH * row[key]
        print(f"{args.label} {args.dtype}: stage {stage} {name:4s} M {M:6d} Nout {Nout:4d} K "
              f"{K:4d}: kernel {k_ms:.4f} ms, F.linear {lib_ms:.4f} ms, bound {bound:.4f} ms, "
              f"kernel / bound {k_ms / bound:.2f}, max abs err {err:.2e}"
              + (f", plan {row['plan']}" if "plan" in row else ""), flush=True)
        if args.plans:
            print("    plans: " + ", ".join(f"{p} {v['ms']:.4f}{'' if v['equal_bits'] else ' UNEQUAL'}"
                                          for p, v in row["plans"].items()))
        del a, w, bias, kw, out, ab, bb
    for stage in sorted({r["stage"] for r in rows}):
        part = [r for r in rows if r["stage"] == stage]
        print(f"{args.label} {args.dtype}: stage {stage}, a forward ({cs.DEPTH} blocks): kernel "
              f"{cs.DEPTH * sum(r['ms'] for r in part):.4f} ms, F.linear "
              f"{cs.DEPTH * sum(r['library_ms'] for r in part):.4f} ms, bound "
              f"{cs.DEPTH * sum(r['bound_ms'] for r in part):.4f} ms (with A and the result in "
              f"bf16 {cs.DEPTH * sum(r['bound_bf16_io_ms'] for r in part):.4f} ms)")
    print(f"{args.label} {args.dtype}: a forward, {cs.DEPTH * len(rows)} launches: kernel "
          f"{total['ms']:.4f} ms, F.linear "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (with A and the "
          f"result in bf16 {total['bound_bf16_io_ms']:.4f} ms)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"linear_times_{args.dtype}_{args.label}.json")
        with open(path, "w") as f:
            json.dump({"launches": rows, "forward": total}, f, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
