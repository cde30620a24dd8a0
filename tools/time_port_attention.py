"""Times K1 `attention` of the PyTorch port at every launch of the headline forward.

The headline forward (TSCD / MiT-B1, 8 x 512 x 512, ``chip_smoke.py``) launches
`attention` once a block, two blocks a stage: stages 1-3 export nothing (N, Nk) =
(16384, 256), (4096, 256), (1024, 256), stage 4 exports its raw logits at N = Nk = 1024.
For each of the four geometries this prints the kernel's time, its bound, and for the
launches that export nothing the time of ``F.scaled_dot_product_attention`` on the same
tensors cast to the operand type (the library call that computes the same function; none
exports the logits). The bound is the larger of the launch's bytes (q and kv read once,
the output and the logits written once) over 3.35 TB/s and its operations (q k^T and p v,
4 B N Nk C) over 989 TFLOP/s (bf16) or, as three TF32 products each, over 494.7 TFLOP/s
(f32), as ``chip_smoke.py`` computes it. Times are taken by replaying a CUDA graph of ten
calls (``chip_smoke.Phases.graph_ms``), so the host's time to launch does not count; the
sums are per forward (x 2 blocks a stage). Beside each launch it prints the first 16 hex
digits of the SHA-256 of its output (and logits), so that two trees are compared bit for
bit. ``--dtype f32`` (the default) times the f32 operand path (3xTF32, TF32 off for the
library call), ``--dtype bf16`` the bf16 one. With ``--plans`` it also times every plan
of the f32 kernel at each geometry (64 and 128 queries a block, with 1, 3 and the plan's
number of persistent blocks) and checks that all give equal bits; without it the script
also runs on a tree whose wrapper has no plan.

Usage, from the root of the repository: ``python tools/time_port_attention.py
[--dtype f32|bf16] [--seed N] [--plans] [--label NAME] [--out DIR]``. It needs a CUDA
card and imports no JAX.
"""
import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launches(cs):
    """(stage, B, N, Nk, C, nh, export) of the attention of one block of each stage of the
    headline forward."""
    return [(i, cs.BATCH, hw * hw, (hw // sr) ** 2, C, nh, export)
            for i, (hw, C, nh, sr, export) in enumerate(cs.STAGES, start=1)]


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
    for stage, B, N, Nk, C, nh, export in launches(cs):
        q = torch.randn(B, N, C, generator=gen).to(dev)
        kv = torch.randn(B, Nk, 2 * C, generator=gen).to(dev)
        kw = {"nh": nh, "dtype": dtype, "export": export}
        got = tmb.attention(q, kv, **kw)
        want = tmb.attention_reference(q, kv, **kw)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in got if t is not None))
        flops, peak = cs.k1_flops("attention", (q, kv), kw)
        if dtype == torch.float32:   # three TF32 products each
            flops, peak = 3.0 * flops, cs.PEAK_TF32
        t_bytes = 1e3 * cs.nbytes((q, kv), got) / cs.PEAK_BYTES
        t_ops = 1e3 * flops / peak
        k_ms = ph.graph_ms(lambda: tmb.attention(q, kv, **kw))
        lib = ph._library_call("attention", (q, kv), {"nh": nh, "export": export}, dtype)
        lib_ms = None if lib is None else ph.graph_ms(lib)
        row = {"stage": stage, "B": B, "N": N, "Nk": Nk, "C": C, "nh": nh, "export": export,
               "ms": k_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, "max_abs_err": err, "sha256": digest.hexdigest()[:16]}
        if args.plans and dtype == torch.float32:
            row["plan"] = list(tmb.attention_plan(B, N, Nk, C, nh, dtype))
            row["plans"] = {}
            for p in cs.attention_plans(tmb, B, N, Nk, C, nh):
                again = tmb.attention(q, kv, plan=p, **kw)
                same = torch.equal(again[0], got[0]) and (not export or torch.equal(again[1], got[1]))
                row["plans"][str(p)] = {"ms": ph.graph_ms(lambda: tmb.attention(q, kv, plan=p, **kw)),
                                        "equal_bits": bool(same)}
        rows.append(row)
        print(f"{args.label} {args.dtype}: stage {stage} N {N:5d} Nk {Nk:4d} C {C:3d} nh {nh}"
              f"{' exporting' if export else ''}: kernel {k_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; kernel / bound {k_ms / row['bound_ms']:.2f}), SDPA "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, max abs err {err:.2e}, SHA-256 "
              f"{row['sha256']}"
              + (f", plan {tuple(row['plan'])}" if "plan" in row else ""), flush=True)
        if "plans" in row:
            print("    plans: " + ", ".join(f"{p} {v['ms']:.4f}{'' if v['equal_bits'] else ' UNEQUAL'}"
                                          for p, v in row["plans"].items()))
        del q, kv, got, want
    quiet = [r for r in rows if not r["export"]]
    loud = [r for r in rows if r["export"]]
    total = {"ms": cs.DEPTH * sum(r["ms"] for r in rows),
             "bound_ms": cs.DEPTH * sum(r["bound_ms"] for r in rows),
             "no_export_ms": cs.DEPTH * sum(r["ms"] for r in quiet),
             "no_export_bound_ms": cs.DEPTH * sum(r["bound_ms"] for r in quiet),
             "no_export_library_ms": cs.DEPTH * sum(r["library_ms"] or 0.0 for r in quiet),
             "export_ms": cs.DEPTH * sum(r["ms"] for r in loud),
             "export_bound_ms": cs.DEPTH * sum(r["bound_ms"] for r in loud)}
    print(f"{args.label} {args.dtype}: a forward, {cs.DEPTH * len(rows)} launches: kernel "
          f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms ({total['bound_ms'] / total['ms']:.0%} "
          f"of it); the {cs.DEPTH * len(quiet)} that export nothing {total['no_export_ms']:.4f} ms "
          f"(bound {total['no_export_bound_ms']:.4f}, SDPA {total['no_export_library_ms']:.4f}); the "
          f"{cs.DEPTH * len(loud)} that export {total['export_ms']:.4f} ms (bound "
          f"{total['export_bound_ms']:.4f})")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"attention_times_{args.dtype}_{args.label}.json")
        with open(path, "w") as f:
            json.dump({"launches": rows, "forward": total}, f, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
