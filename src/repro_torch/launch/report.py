"""Render EXPERIMENTS.md tables from dry-run / hillclimb JSON records.

    python -m repro_torch.launch.report --dryrun results/dryrun \
        --hillclimb results/hillclimb
"""
import argparse
import glob
import json
import os


def load(d):
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        out.append(json.load(open(f)))
    return out


def fmt(v, digits=3):
    if v is None:
        return "-"
    if abs(v) >= 100:
        return f"{v:,.0f}"
    return f"{v:.{digits}f}"


def dryrun_table(recs):
    print("| arch | shape | mesh | chips | compile s | flops/dev | "
          "HBM B/dev | coll B/dev | args B/dev | temp B/dev |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("status") == "skipped":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | "
                  f"SKIP ({r['reason'][:40]}...) | | | | | |")
            continue
        if r.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | "
                  f"ERROR | | | | | |")
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} | "
              f"{r['compile_s']} | {r['flops_per_device']:.3e} | "
              f"{r['bytes_per_device']:.3e} | "
              f"{r['collective_bytes']['total']:.3e} | "
              f"{r.get('argument_size_in_bytes', 0):.3e} | "
              f"{r.get('temp_size_in_bytes', 0):.3e} |")


def roofline_table(recs, mesh="single"):
    print("| arch | shape | compute s | memory s | memory s (flash) | "
          "collective s | dominant | MODEL_FLOPS | useful ratio | "
          "roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        print(f"| {r['arch']} | {r['shape']} | {fmt(r['compute_s'])} | "
              f"{fmt(r['memory_s'])} | {fmt(r.get('memory_flash_s'))} | "
              f"{fmt(r['collective_s'])} | {r['dominant']} | "
              f"{r['model_flops']:.2e} | {fmt(r['useful_ratio'], 2)} | "
              f"{100 * r['roofline_fraction']:.1f}% |")


def perf_table(recs):
    print("| cell | tag | compute s | memory s | collective s | dominant | "
          "bound s |")
    print("|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("status") != "ok":
            continue
        tag = "baseline"
        # tags are embedded in filenames; re-derive from extra key if set
        print(f"| {r['arch']}/{r['shape']}/{r['mesh']} | "
              f"{r.get('tag', tag)} | {fmt(r['compute_s'])} | "
              f"{fmt(r['memory_s'])} | {fmt(r['collective_s'])} | "
              f"{r['dominant']} | "
              f"{fmt(r['step_time_lower_bound_s'])} |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun")
    ap.add_argument("--hillclimb", default="results/hillclimb")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "perf"])
    args = ap.parse_args()

    dr = load(args.dryrun)
    # attach tags from filenames
    for f, r in zip(sorted(glob.glob(os.path.join(args.dryrun, "*.json"))),
                    dr):
        r["tag"] = os.path.basename(f).rsplit("__", 1)[1][:-5]
    if args.section in ("all", "dryrun"):
        print("## §Dry-run (both meshes, every cell)\n")
        dryrun_table(dr)
        print()
    if args.section in ("all", "roofline"):
        print("## §Roofline (single-pod 16x16 = 256 chips)\n")
        roofline_table(dr, "single")
        print()
    if args.section in ("all", "perf") and os.path.isdir(args.hillclimb):
        hc = load(args.hillclimb)
        for f, r in zip(sorted(glob.glob(
                os.path.join(args.hillclimb, "*.json"))), hc):
            r["tag"] = os.path.basename(f).rsplit("__", 1)[1][:-5]
        print("## §Perf iterations (hillclimb cells)\n")
        perf_table(hc)


if __name__ == "__main__":
    main()
