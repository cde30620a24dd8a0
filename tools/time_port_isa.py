"""Times K6 `isa_core` of the PyTorch port at the RSSFormer predict path's shape.

The predict forward (``HRNetFusion("hrnetv2_w32")``, 4 x 512 x 512,
``chip_smoke.py``) launches K6 once a transformer block, eight times a forward,
each on 1444 windows of 49 tokens x 32 channels, 2 heads, bf16 operands. This
prints the kernel's time a launch under bf16 and f32 operands, that of
``F.scaled_dot_product_attention`` on the same heads in bf16 (the softmax
attention without the DAL gate), the plain version's, and the launch's bound:
the larger of its bytes (q, k, v read once, the output written once) over 3.35
TB/s and its operations over 989 TFLOP/s, as ``chip_smoke.py`` computes it. The
kernel and the library call are timed by replaying a CUDA graph of ten calls
(``chip_smoke.Phases.graph_ms``), so the host's time to launch does not count.
With ``--plans`` it also times every plan of the kernel (windows a step 1, 2, 4;
ring stages 2, 3), prints the blocks an SM holds of each, checks that all give
the same bits, and prints what ``ptxas -v`` said of the kernel's instantiations.
With ``--agreement`` it prints the largest error against the plain version, as a
share of ``chip_smoke.py``'s bf16 tolerance, over six sets of inputs: the three of
``chip_smoke.py``'s K6 phase at this shape (1444, 1 and 1443 windows) and 1444
windows from seeds 1, 2 and 3.

Usage, from the root of the repository: ``python tools/time_port_isa.py [--seed N]
[--plans] [--agreement] [--label NAME] [--out DIR]``. It needs a CUDA card and imports no JAX. It
also runs on a tree whose wrapper has no plan (without ``--plans``).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--agreement", action="store_true")
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
    from representationlearning_tpu_torch.ops import isa_attention as ti

    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"{args.label}: {card}")
    ph = cs.Phases(torch, args.seed)
    dev, f32, bf16 = ph.dev, torch.float32, torch.bfloat16
    side = -(-(cs.IMAGE // 4) // cs.RSS_WINDOW)
    NW, T, C, nh = cs.RSS_BATCH * side * side, cs.RSS_WINDOW ** 2, cs.RSS_DIM, cs.RSS_HEADS
    hd = C // nh
    gen = torch.Generator().manual_seed(args.seed)
    q, k, v = (torch.randn(NW, T, C, generator=gen).to(dev) for _ in range(3))
    q = q * hd ** -0.5

    def heads(t):
        return t.to(bf16).reshape(NW, T, nh, hd).transpose(1, 2).contiguous()

    qh, kh, vh = heads(q), heads(k), heads(v)
    res = {"label": args.label, "card": card, "NW": NW, "T": T, "C": C, "nh": nh}
    with torch.no_grad():
        out = ti.isa_core(q, k, v, nh=nh, dtype=bf16)
        res["max_abs_err"] = (out - ti.isa_core_reference(q, k, v, nh=nh, dtype=bf16)
                              ).abs().max().item()
        res["max_abs_err_f32"] = (ti.isa_core(q, k, v, nh=nh, dtype=f32)
                                  - ti.isa_core_reference(q, k, v, nh=nh)).abs().max().item()
        res["ms"] = ph.graph_ms(lambda: ti.isa_core(q, k, v, nh=nh, dtype=bf16))
        res["ms_f32"] = ph.graph_ms(lambda: ti.isa_core(q, k, v, nh=nh, dtype=f32))
        res["library_ms"] = ph.graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                               scale=1.0))
        res["plain_ms"] = ph.time_ms(lambda: ti.isa_core_reference(q, k, v, nh=nh, dtype=bf16),
                                     iters=5)
        n_bytes = cs.nbytes(q, k, v, out)
        flops = NW * (4.0 * T * T * C + 2.0 * T * C * hd)
        res["bound_ms"] = 1e3 * max(n_bytes / cs.PEAK_BYTES, flops / cs.PEAK_BF16)
        if hasattr(ti, "isa_plan"):
            res["plan"] = ti.isa_plan(NW, T, C, nh, bf16)
        if args.agreement:
            sets = []
            g7 = torch.Generator().manual_seed(7)  # chip_smoke.py's K6 phase at seed 0
            for nw in (NW, 1, NW - 1):
                sets.append([torch.randn(nw, T, C, generator=g7).to(dev) for _ in range(3)])
            for seed in (1, 2, 3):
                gs = torch.Generator().manual_seed(seed)
                sets.append([torch.randn(NW, T, C, generator=gs).to(dev) for _ in range(3)])
            worst = 0.0
            for qs, ks, vs in sets:
                qs = qs * hd ** -0.5
                want = ti.isa_core_reference(qs, ks, vs, nh=nh, dtype=bf16)
                err = (ti.isa_core(qs, ks, vs, nh=nh, dtype=bf16) - want).abs().max().item()
                worst = max(worst, err / (cs.K6_TOL["bfloat16"] * max(1.0, want.abs().max().item())))
            res["worst_err_over_tol"] = worst
        if args.plans:
            lib = _build.load_library("rssformer")
            res["plans"] = {}
            plans = {(w, min(ti.ISA_MAX_WARPS, f * w * nh), s) for w in (1, 2, 4)
                     for s in (2, 3) for f in (1, 2, 4)}
            for plan in sorted(plans):
                smem = ti.isa_smem_bytes(T, C, nh, plan[0], plan[2])
                if smem > ti.SMEM_LIMIT:
                    continue
                got = ti.isa_core(q, k, v, nh=nh, dtype=bf16, plan=plan)
                res["plans"][str(plan)] = {
                    "ms": ph.graph_ms(lambda: ti.isa_core(q, k, v, nh=nh, dtype=bf16,
                                                           plan=plan)),
                    "blocks_per_sm": lib.k6_isa_blocks_per_sm(T, C, nh, 1, *plan),
                    "smem": smem, "equal_bits": bool(torch.equal(got, out))}
            log = _build.build_log.get("rssformer", {}).get("ptxas", "")
            lines = log.splitlines()
            res["ptxas"] = [" | ".join(x.strip() for x in lines[i:i + 4])
                            for i, a in enumerate(lines)
                            if "Compiling entry function" in a and "isa_kernel" in a]
    print(f"{args.label}: K6 a launch {res['ms']:.4f} ms (a forward of {cs.RSS_BLOCKS}: "
          f"{cs.RSS_BLOCKS * res['ms']:.4f}), f32 operands {res['ms_f32']:.4f} ms, "
          f"F.scaled_dot_product_attention {res['library_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms, kernel / bound "
          f"{res['ms'] / res['bound_ms']:.2f}, max abs err {res['max_abs_err']:.2e} "
          f"(f32 {res['max_abs_err_f32']:.2e})" + (f", plan {res['plan']}" if "plan" in res else ""))
    if "worst_err_over_tol" in res:
        print(f"  largest error over six input sets: {res['worst_err_over_tol']:.4f} of the tolerance")
    for plan, r in res.get("plans", {}).items():
        print(f"  plan {plan}: {1e3 * r['ms']:.2f} us, {r['blocks_per_sm']} blocks an SM, "
              f"{r['smem']} bytes, equal bits {r['equal_bits']}")
    for line in res.get("ptxas", []):
        print(f"  ptxas: {line}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"isa_times_{args.label}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
