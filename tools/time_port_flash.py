"""Times K4 (flash attention) of the PyTorch port, both directions, at the train step's geometries.

The SCD train step (``chip_smoke.py``, 8 x 320 x 320, ``TSCD("mit_b1", use_flash=True)``
in f32) launches K4 forward and backward twice (depth 2) at each of six (BH, Nq, Nk)
geometries, hd 64: (8, 6400, 100), (16, 1600, 100), (40, 400, 100) in the main forward and
(8, 576, 9), (16, 144, 9), (40, 36, 9) in the 0.3-scale forward; ``TSCD(use_flash=True)``
at 512 x 512 runs (8, 16384, 256), (16, 4096, 256), (40, 1024, 256) forward. At each
geometry this prints the forward's time a launch on f32 and on bf16 tensors, that of
``F.scaled_dot_product_attention`` on the same tensors in f32 and in bf16, and the
launch's bounds: its bytes (q, k, v read once, o and the row logsumexp written once) over
3.35 TB/s, its operations (4 BH Nq Nk hd) over 67 TFLOP/s as f32 multiply-adds and, as
the kernel runs them, as three TF32 products each over 494.7 TFLOP/s; and a SHA-256 of the
forward's o and lse on the seeded f32 inputs (equal between two trees whose forward gives
the same bits). At the train geometries it times the backward: through
``torch.autograd.grad`` (``bwd_ms``, the forward run on the capture stream first; the same
on any tree), the backward kernel alone (``bwd_kernel_ms``, ``flash_backward`` with its
plan, where the tree has it) and the library's backward, beside the backward's bounds
(q, k, v, o, do and lse read, dq, dk, dv written; 10 BH Nq Nk hd operations as 3xTF32 and
as f32 multiply-adds) and its workspace. Every time is by replaying a CUDA graph of ten
calls (``chip_smoke.Phases.graph_ms``), so the host's time to launch does not count. Then
the sums over the step's 12 launches of each direction. It also names the kernels that
``F.scaled_dot_product_attention`` runs on f32 and bf16 (from a ``torch.profiler``
trace). With ``--plans`` it times every plan of the forward at every geometry (warps a
block 1, 2, 4, 8; the blocks the card holds, and half of them) and of the backward at the
train geometries (``chip_smoke.bwd_plans``), checks that the forward's give the same bits
and each backward plan the same bits on a rerun, and prints what ``ptxas -v`` said of
both directions' instantiations.

Usage, from the root of the repository: ``python tools/time_port_flash.py [--seed N]
[--plans] [--label NAME] [--out DIR]``. It needs a CUDA card and imports no JAX. It also
runs on a tree whose wrapper has no plan and no ``flash_backward`` (without ``--plans``).
"""
import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_TF32 = 494.7e12  # dense TF32 tensor-core FLOP/s of one H100 SXM


def library_kernels(torch, fn) -> list[str]:
    """Names of the device kernels one call of fn launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0})


def sha256(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
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
    from representationlearning_tpu_torch.ops import attention as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"{args.label}: {card}")
    ph = cs.Phases(torch, args.seed)
    dev, f32, bf16 = ph.dev, torch.float32, torch.bfloat16
    hd, scale = cs.HD, cs.HD ** -0.5
    train = cs.flash_shapes(cs.CROP) + cs.flash_shapes(int(cs.CROP * 0.3))
    gen = torch.Generator().manual_seed(args.seed)
    has_plan = hasattr(tf, "flash_plan")
    has_bwd = hasattr(tf, "flash_backward")
    res = {"label": args.label, "card": card, "geometries": {}}
    sums = {}
    for shape in train + cs.flash_shapes(cs.IMAGE):
        BH, Nq, Nk = shape
        q, k, v = (torch.randn(BH, n, hd, generator=gen).to(dev) for n in (Nq, Nk, Nk))
        qb, kb, vb = q.to(bf16), k.to(bf16), v.to(bf16)
        with torch.no_grad():
            out = tf.flash_attention(q, k, v, scale)
            want = tf.flash_attention_reference(q, k, v, scale)
            r = {"max_abs_err": (out - want).abs().max().item(),
                 "max_abs_err_bf16": (tf.flash_attention(qb, kb, vb, scale).float()
                                      - want).abs().max().item(),
                 "ms": ph.graph_ms(lambda: tf.flash_attention(q, k, v, scale)),
                 "ms_bf16": ph.graph_ms(lambda: tf.flash_attention(qb, kb, vb, scale)),
                 "library_ms": ph.graph_ms(lambda: F.scaled_dot_product_attention(
                     q[None], k[None], v[None], scale=scale)),
                 "library_ms_bf16": ph.graph_ms(lambda: F.scaled_dot_product_attention(
                     qb[None], kb[None], vb[None], scale=scale))}
        if hasattr(tf, "flash_forward"):
            with torch.no_grad():
                r["sha256_o_lse"] = sha256(*tf.flash_forward(q, k, v, scale))
        ops = 4.0 * BH * Nq * Nk * hd
        r["bound_bytes_ms"] = 1e3 * (cs.nbytes(q, k, v, out) + 4 * BH * Nq) / cs.PEAK_BYTES
        r["bound_f32_ms"] = 1e3 * ops / cs.PEAK_F32
        r["bound_3xtf32_ms"] = 1e3 * 3 * ops / PEAK_TF32
        if has_plan:  # the plan the wrapper chose, with the card's occupancy
            warps = tf.flash_plan(BH, Nq, Nk, hd, f32, sms=tf._sms(0))[0]
            r["plan"] = list(tf.flash_plan(BH, Nq, Nk, hd, f32,
                                           tf._blocks_per_sm(Nk, hd, False, warps), tf._sms(0)))
        if shape in train:
            for key in ("ms", "ms_bf16", "library_ms", "library_ms_bf16", "bound_bytes_ms",
                        "bound_f32_ms", "bound_3xtf32_ms"):
                sums[key] = sums.get(key, 0.0) + cs.DEPTH * r[key]
            # backward by replay of a captured autograd.grad, the forward on that stream
            do = torch.randn(BH, Nq, hd, generator=gen).to(dev)
            bops = 10.0 * BH * Nq * Nk * hd
            r["bwd_bound_bytes_ms"] = 1e3 * (cs.nbytes(q, k, v, out, do) + cs.nbytes(q, k, v)
                                             + 4 * BH * Nq) / cs.PEAK_BYTES
            r["bwd_bound_3xtf32_ms"] = 1e3 * 3 * bops / PEAK_TF32
            r["bwd_bound_f32_ms"] = 1e3 * bops / cs.PEAK_F32
            r["bwd_bound_ms"] = max(r["bwd_bound_bytes_ms"], r["bwd_bound_3xtf32_ms"])
            try:
                if ph.capture_stream is None:
                    ph.capture_stream = torch.cuda.Stream()
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                ph.capture_stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(ph.capture_stream):
                    o_k = tf.flash_attention(qg, kg, vg, scale)
                    o_l = F.scaled_dot_product_attention(qg[None], kg[None], vg[None],
                                                         scale=scale)[0]
                torch.cuda.current_stream().wait_stream(ph.capture_stream)
                r["bwd_ms"] = ph.graph_ms(lambda: torch.autograd.grad(
                    o_k, (qg, kg, vg), do, retain_graph=True))
                r["library_bwd_ms"] = ph.graph_ms(lambda: torch.autograd.grad(
                    o_l, (qg, kg, vg), do, retain_graph=True))
                for key in ("bwd_ms", "library_bwd_ms"):
                    sums[key] = sums.get(key, 0.0) + cs.DEPTH * r[key]
            except Exception as e:  # noqa: BLE001 -- report why the replay failed
                r["bwd_replay_error"] = f"{type(e).__name__}: {e}"
                torch.cuda.synchronize()
            for key in ("bwd_bound_ms", "bwd_bound_3xtf32_ms", "bwd_bound_f32_ms",
                        "bwd_bound_bytes_ms"):
                sums[key] = sums.get(key, 0.0) + cs.DEPTH * r[key]
            if has_bwd:
                with torch.no_grad():
                    o1, lse1 = tf.flash_forward(q, k, v, scale)
                plan = tf.bwd_plan(BH, Nq, Nk, hd, f32, sms=tf._sms(0))
                plan = tf.bwd_plan(BH, Nq, Nk, hd, f32, tf._bwd_blocks_per_sm(Nk, hd, False,
                                                                             plan[0]), tf._sms(0))
                r["bwd_plan"] = list(plan)
                r["bwd_workspace_mb"] = 4e-6 * tf.bwd_workspace_floats(BH, Nq, Nk, hd, plan[1])
                bgot = tf.flash_backward(q, k, v, o1, lse1, do, scale)
                bwant = tf.flash_backward_reference(q, k, v, do, scale)
                r["bwd_max_abs_err"] = max((a - b).abs().max().item()
                                           for a, b in zip(bgot, bwant))
                r["bwd_kernel_ms"] = ph.graph_ms(lambda: tf.flash_backward(q, k, v, o1, lse1, do,
                                                                           scale))
                sums["bwd_kernel_ms"] = sums.get("bwd_kernel_ms", 0.0) + cs.DEPTH * r["bwd_kernel_ms"]
                if args.plans:
                    r["bwd_plans"] = {}
                    for bp in cs.bwd_plans(tf, BH, Nq, Nk, hd, f32):
                        a = tf.flash_backward(q, k, v, o1, lse1, do, scale, plan=bp)
                        b = tf.flash_backward(q, k, v, o1, lse1, do, scale, plan=bp)
                        r["bwd_plans"][str(bp)] = {
                            "ms": ph.graph_ms(lambda: tf.flash_backward(q, k, v, o1, lse1, do,
                                                                        scale, plan=bp)),
                            "equal_bits": all(torch.equal(x, y) for x, y in zip(a, b)),
                            "max_abs_err": max((x - w).abs().max().item()
                                               for x, w in zip(a, bwant))}
                del o1, lse1, bgot, bwant
        if args.plans and has_plan:
            r["plans"] = {}
            o0, l0 = tf.flash_forward(q, k, v, scale)
            per = {w: tf._blocks_per_sm(Nk, hd, False, w) for w in (1, 2, 4, 8)}
            tiles = BH * -(-Nq // 16)
            for w, n in per.items():
                full = min(-(-tiles // w), n * tf._sms(0))
                for blocks in sorted({full, max(1, full // 2)}):
                    plan = (w, blocks)
                    o1, l1 = tf.flash_forward(q, k, v, scale, plan)
                    r["plans"][str(plan)] = {
                        "ms": ph.graph_ms(lambda: tf.flash_forward(q, k, v, scale, plan)),
                        "blocks_per_sm": n,
                        "equal_bits": bool(torch.equal(o0, o1) and torch.equal(l0, l1))}
        res["geometries"][str(shape)] = r
        line = (f"{args.label}: ({BH}, {Nq}, {Nk}) K4 fwd {1e3 * r['ms']:.2f} us (bf16 "
                f"{1e3 * r['ms_bf16']:.2f}), SDPA f32 {1e3 * r['library_ms']:.2f} us (bf16 "
                f"{1e3 * r['library_ms_bf16']:.2f}), bounds bytes "
                f"{1e3 * r['bound_bytes_ms']:.2f} / 3xTF32 {1e3 * r['bound_3xtf32_ms']:.2f} / "
                f"f32 {1e3 * r['bound_f32_ms']:.2f} us, err {r['max_abs_err']:.2e} "
                f"(bf16 {r['max_abs_err_bf16']:.2e})")
        if "plan" in r:
            line += f", plan {tuple(r['plan'])}"
        if "sha256_o_lse" in r:
            line += f", sha256(o, lse) {r['sha256_o_lse']}"
        print(line)
        if "bwd_bound_ms" in r:
            line = (f"{args.label}: ({BH}, {Nq}, {Nk}) K4 bwd")
            if "bwd_kernel_ms" in r:
                line += (f" kernel {1e3 * r['bwd_kernel_ms']:.2f} us (plan {tuple(r['bwd_plan'])}, "
                         f"workspace {r['bwd_workspace_mb']:.2f} MB, err "
                         f"{r['bwd_max_abs_err']:.2e}),")
            if "bwd_ms" in r:
                line += (f" through autograd {1e3 * r['bwd_ms']:.2f} us, library bwd "
                         f"{1e3 * r['library_bwd_ms']:.2f} us,")
            line += (f" bounds bytes {1e3 * r['bwd_bound_bytes_ms']:.2f} / 3xTF32 "
                     f"{1e3 * r['bwd_bound_3xtf32_ms']:.2f} / f32 "
                     f"{1e3 * r['bwd_bound_f32_ms']:.2f} us")
            print(line)
        if "bwd_replay_error" in r:
            print(f"  backward replay failed: {r['bwd_replay_error']}")
        for plan, p in r.get("plans", {}).items():
            print(f"  plan {plan}: {1e3 * p['ms']:.2f} us, {p['blocks_per_sm']} blocks an SM, "
                  f"equal bits {p['equal_bits']}")
        for plan, p in r.get("bwd_plans", {}).items():
            print(f"  bwd plan {plan}: {1e3 * p['ms']:.2f} us, equal bits on a rerun "
                  f"{p['equal_bits']}, err {p['max_abs_err']:.2e}")
        del q, k, v, qb, kb, vb, out, want
        torch.cuda.empty_cache()
    res["step_sums"] = sums
    print(f"{args.label}: the step's {cs.DEPTH * len(train)} launches of each direction: " +
          ", ".join(f"{key} {v:.4f}" for key, v in sums.items()) + " ms")
    q, k, v = (torch.randn(8, n, hd, generator=gen).to(dev) for n in (6400, 100, 100))
    for name, dt in (("f32", f32), ("bf16", bf16)):
        qs, ks, vs = q.to(dt)[None], k.to(dt)[None], v.to(dt)[None]
        names = library_kernels(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                              scale=scale))
        res[f"library_kernels_{name}"] = names
        print(f"{args.label}: F.scaled_dot_product_attention {name} at (8, 6400, 100) runs "
              f"{names}")
    if args.plans:
        lines = _build.build_log.get("attention", {}).get("ptxas", "").splitlines()
        res["ptxas"] = [" | ".join(x.strip() for x in lines[i:i + 4])
                        for i, a in enumerate(lines)
                        if "Compiling entry function" in a and "flash_" in a]
        for line in res["ptxas"]:
            print(f"  ptxas: {line}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"flash_times_{args.label}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
