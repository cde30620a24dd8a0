"""Times the refinement kernels K2 (`affinity`) and K3 (`varm_propagate`) of the PyTorch port.

The SCD pseudo-label call refines its CAMs at half the crop (8 x 160 x 160, dilations
(1, 2, 4, 8, 12, 24), K = 48 taps): one K2 launch in varm mode, then ten K3 launches at
2 * (max_present + 1) = 18 mask planes (42 with ``max_present=None``). This times K2
in its three modes and K3 at 18 and 42 planes, at 160 x 160 and 256 x 256 with batch 8,
by replaying a CUDA graph of ten calls (``chip_smoke.Phases.graph_ms``), so the host's
time to launch does not count. Beside each it prints the bound as ``chip_smoke.py``
computes it (the larger of every input read once and every output written once over
3.35 TB/s and the operations over 67 TFLOP/s), K3's floor of its unfused multiplies
and adds at the f32 instruction rate (two instructions a tap and output, 33.5 T/s), and the
bytes a launch copies from L2 into shared memory under its plan (the staged tiles and
their halos; K3's weights go from L2 into registers, printed apart). A tree whose
wrappers take no plan (one thread a pixel, everything read through L1) stages nothing
and prints none. With ``--plans`` it times every plan at every shape, checks that all
give the same bits, checks the blocks an SM holds against the plans' estimates, and
prints what ``ptxas -v`` said of the kernels.

Usage, from the root of the repository: ``python tools/time_port_refine.py [--seed N]
[--plans] [--label NAME] [--out DIR]``. It needs a CUDA card and imports no JAX. It
also runs on a tree whose wrappers take no plan (without ``--plans``).
"""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DILATIONS = (1, 2, 4, 8, 12, 24)
# f32 multiplies or adds a second: half of 67 TFLOP/s, which counts an FMA as two
F32_RATE = 33.5e12


def varm_l2_bytes(tv, B, C, H, W, plan) -> tuple[int, int]:
    """(staged, weights) bytes a K3 launch copies from L2: every step stages its box
    (`varm_planes` planes of a tile plus its halo, the box's padding and the places
    outside the plane included) into shared memory; every block loads the weights of
    each tile its steps touch into registers."""
    tile_rows, pixels, blocks = plan
    srows, pitch, _ = tv.varm_geometry(H, W, DILATIONS, tile_rows, pixels)
    K = 8 * len(DILATIONS)
    staged = weights = 0
    for g in range(min(blocks, tv.varm_units(B, C, H, W, *plan[:2]))):
        steps = tv.varm_steps(B, C, H, W, plan, g)
        staged += len(steps) * tv.varm_planes(pixels) * srows * pitch
        for b, _, _, ty, tx in dict.fromkeys((s[0], 0, 0, s[3], s[4]) for s in steps):
            weights += min(tile_rows, H - ty * tile_rows) * min(32, W - tx * 32)
    return 4 * staged, 4 * K * weights


def affinity_l2_bytes(ta, B, H, W, mode, plan) -> int:
    """Bytes a K2 launch copies from L2 into shared memory: each block its staged
    three planes (tile, halo, the next row and column)."""
    rows, _ = plan
    hy, hx4 = ta._halos(H, W, DILATIONS)
    staged = 3 * (rows + 2 * hy + 1) * (32 + 2 * hx4 + 4)
    return 4 * B * math.ceil(H / rows) * math.ceil(W / 32) * staged


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card only", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from representationlearning_tpu_torch.ops import _build
    from representationlearning_tpu_torch.ops import affinity as ta
    from representationlearning_tpu_torch.ops import varm as tv

    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"{args.label}: {card}")
    ph = cs.Phases(torch, args.seed)
    dev = ph.dev
    gen = torch.Generator().manual_seed(args.seed)
    has_plan = hasattr(tv, "varm_plan")
    plans = args.plans and has_plan
    iters = cs.VARM_ITERS
    K = 8 * len(DILATIONS)
    res = {"label": args.label, "card": card, "affinity": [], "varm_propagate": []}
    lib = _build.load_library("refine")
    if plans:
        res["blocks_per_sm"] = {}
        for (rows, held) in ta.AFFINITY_KERNELS:
            for mode in ("par", "varm"):
                smem = ta.affinity_smem_bytes(160, 160, DILATIONS, mode, rows, held)
                key = f"affinity {mode} {(rows, held)}"
                res["blocks_per_sm"][key] = (
                    lib.k2_affinity_blocks_per_sm(ta.MODES[mode], rows, held, smem),
                    ta.affinity_blocks_per_sm(rows, held, mode, smem))
        for k in tv.VARM_KERNELS:
            smem = tv.varm_geometry(160, 160, DILATIONS, *k)[2]
            res["blocks_per_sm"][f"varm {k}"] = (lib.k3_varm_blocks_per_sm(*k, smem),
                                                 tv.varm_blocks_per_sm(*k, smem))
        for key, (card_n, est) in res["blocks_per_sm"].items():
            print(f"  blocks an SM holds, {key}: card {card_n}, estimate {est}")
    for S in (160, 256):
        B = cs.BATCH
        with torch.no_grad():
            img = (torch.rand((B, 3, S, S), generator=gen) * 255.0).to(dev)
            for mode in ("varm", "par", "pamr"):
                out = ta.affinity(img, DILATIONS, mode)
                err = (out - ta.affinity_reference(img, DILATIONS, mode)).abs().max().item()
                plan = ta.affinity_plan(B, S, S, DILATIONS, mode) if has_plan else None
                row = {"S": S, "mode": mode, "plan": plan, "max_abs_err": err,
                       "ms": ph.graph_ms(lambda: ta.affinity(img, DILATIONS, mode)),
                       "bytes": cs.nbytes(img, out), "ops": 56.0 * B * S * S * K}
                row["bound_ms"] = 1e3 * max(row["bytes"] / cs.PEAK_BYTES, row["ops"] / cs.PEAK_F32)
                row["l2_shared_bytes"] = (affinity_l2_bytes(ta, B, S, S, mode, plan)
                                          if plan else None)
                if plans:
                    row["plans"] = {}
                    for pl in sorted(ta.AFFINITY_KERNELS):
                        if ta.affinity_takes(S, S, DILATIONS, mode, *pl):
                            got = ta.affinity(img, DILATIONS, mode, plan=pl)
                            row["plans"][str(pl)] = {
                                "ms": ph.graph_ms(
                                    lambda: ta.affinity(img, DILATIONS, mode, plan=pl)),
                                "l2_shared_bytes": affinity_l2_bytes(ta, B, S, S, mode, pl),
                                "equal_bits": bool(torch.equal(got, out))}
                res["affinity"].append(row)
                l2 = row["l2_shared_bytes"]
                print(f"{args.label}: affinity {mode} {B} x {S}^2: {1e3 * row['ms']:.2f} us a "
                      f"launch, "
                      f"bound {1e3 * row['bound_ms']:.2f} us (bytes {row['bytes'] / 1e6:.1f} MB), "
                      f"kernel / bound {row['ms'] / row['bound_ms']:.2f}, max abs err {err:.2e}"
                      + (f", plan {plan}, L2 -> shared {l2 / 1e6:.1f} MB" if plan else ""),
                      flush=True)
                for pl, v in row.get("plans", {}).items():
                    print(f"    plan {pl}: {1e3 * v['ms']:.2f} us, L2 -> shared "
                          f"{v['l2_shared_bytes'] / 1e6:.1f} MB, equal bits {v['equal_bits']}")
                del out
            ref = ta.affinity(img, DILATIONS, "varm")
            for C in (2 * (cs.MAX_PRESENT + 1), 2 * cs.NUM_CLASSES):
                m = torch.softmax(4.0 * torch.randn((B, C, S, S), generator=gen), dim=1).to(dev)
                out = tv.varm_propagate(m, ref, DILATIONS, iters)
                same = bool(torch.equal(out, tv.varm_propagate_reference(m, ref, DILATIONS, iters)))
                plan = tv.varm_plan(B, C, S, S, DILATIONS) if has_plan else None
                call = ph.graph_ms(lambda: tv.varm_propagate(m, ref, DILATIONS, iters), iters=3)
                row = {"S": S, "C": C, "plan": plan, "equal_to_plain": same, "ms_call": call,
                       "us_launch": 1e3 * call / iters, "bytes": cs.nbytes(m, ref, m),
                       "ops": 2.0 * m.numel() * K}
                row["bound_us"] = 1e6 * max(row["bytes"] / cs.PEAK_BYTES, row["ops"] / cs.PEAK_F32)
                row["unfused_floor_us"] = 1e6 * row["ops"] / F32_RATE
                row["us_per_plane"] = row["us_launch"] / C
                if plan:
                    row["l2_shared_bytes"], row["l2_weight_bytes"] = varm_l2_bytes(
                        tv, B, C, S, S, plan)
                if plans:
                    row["plans"] = {}
                    for k in sorted(tv.VARM_KERNELS):
                        if not tv.varm_takes(S, S, DILATIONS, *k):
                            continue
                        smem = tv.varm_geometry(S, S, DILATIONS, *k)[2]
                        resident = tv.varm_blocks_per_sm(*k, smem) * tv.SMS
                        for blocks in sorted({resident, 2 * resident, max(1, resident // 2)}):
                            pl = (*k, blocks)
                            got = tv.varm_propagate(m, ref, DILATIONS, iters, plan=pl)
                            again = tv.varm_propagate(m, ref, DILATIONS, iters, plan=pl)
                            sh, wt = varm_l2_bytes(tv, B, C, S, S, pl)
                            row["plans"][str(pl)] = {
                                "us_launch": 1e3 * ph.graph_ms(
                                    lambda: tv.varm_propagate(m, ref, DILATIONS, iters, plan=pl),
                                    iters=3) / iters,
                                "l2_shared_bytes": sh, "l2_weight_bytes": wt,
                                "equal_bits": bool(torch.equal(got, out)
                                                   and torch.equal(again, out))}
                res["varm_propagate"].append(row)
                print(f"{args.label}: varm_propagate C {C} {B} x {S}^2: {row['us_launch']:.2f} us "
                      f"a launch ({call:.4f} ms a call of {iters}; {row['us_per_plane']:.3f} us "
                      f"a plane), bound {row['bound_us']:.2f} us (bytes {row['bytes'] / 1e6:.1f} "
                      f"MB), unfused multiply-add floor {row['unfused_floor_us']:.2f} us, kernel / "
                      f"bound {row['us_launch'] / row['bound_us']:.2f}, equal to plain {same}"
                      + (f", plan {plan}, L2 -> shared {row['l2_shared_bytes'] / 1e6:.1f} MB, "
                         f"L2 -> registers {row['l2_weight_bytes'] / 1e6:.1f} MB" if plan else ""),
                      flush=True)
                for pl, v in row.get("plans", {}).items():
                    print(f"    plan {pl}: {v['us_launch']:.2f} us, L2 -> shared "
                          f"{v['l2_shared_bytes'] / 1e6:.1f} MB + registers "
                          f"{v['l2_weight_bytes'] / 1e6:.1f} MB, equal bits {v['equal_bits']}")
                del m, out
            del img, ref
        torch.cuda.empty_cache()
    res["ptxas"] = ptxas_lines(_build, "refine", "")
    for line in res["ptxas"]:
        print(f"  ptxas: {line}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"refine_times_{args.label}.json")
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1)
        print(f"written: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
