"""The multi-pod dry run.

For every (architecture x input shape) cell, build and trace the real
step function (train_step / prefill / decode) against the production
mesh — (16, 16) single-pod and (2, 16, 16) multi-pod — and record the
per-device FLOPs, HBM bytes and collective traffic to JSON.  This is the
proof that the distribution config is coherent without hardware:
sharding mismatches, unsupported redistributions and layout bugs all
fail HERE.

The JAX package's ``launch/dryrun.py`` sets XLA's host device count to
512 before jax starts; here :func:`fake_group` creates a fake process
group of 256 or 512 ranks (``torch.testing``'s ``FakeStore``: rank 0 of
the group runs, the collectives return fake results) before any mesh.
The step runs once on DTensors whose local shards are fake tensors, so
nothing is allocated on any device and no card is needed.  A record
has the JAX record's keys; ``lower_s`` is the seconds that built the
abstract params and their DTensors, ``compile_s`` the seconds of the
traced step.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
    python -m repro_torch.launch.dryrun --list
"""
import argparse
import json
import os
import sys
import traceback


def fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks (this process is
    rank 0); an existing fake group of at least that many ranks stays."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= world:
            return
        raise RuntimeError("a process group exists: the dry run needs its "
                           "own fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides=None) -> dict:
    from .cells import Cell
    from .mesh import make_production_mesh
    from .roofline import analyze_traced, model_flops_for, roofline_terms

    multi = mesh_kind == "multi"
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": int(chips), "mesh_shape": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names)}
    cell = Cell(arch, shape_name, mesh, overrides=overrides)
    score_dims = None
    if cell.shape.kind in ("train", "prefill") and not cell.cfg.rwkv:
        s = cell.shape.seq_len
        # (kv_len, q_candidates): full-q and q-chunked score shapes both
        score_dims = (s, s, cell.cfg.attention_q_chunk,
                      max(s // cell.cfg.frame_ratio, 1))
    traced = cell.trace(score_dims=score_dims)
    rec["lower_s"] = round(traced.build_s, 2)
    rec.update(analyze_traced(traced, trip_count=cell.trip_count()))
    rec.update(roofline_terms(
        rec, model_flops=model_flops_for(arch, shape_name), chips=chips))
    rec["status"] = "ok"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="architecture id (see --list)")
    ap.add_argument("--shape", help="input shape name")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for per-cell JSON results")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--compression", default=None)
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--rwkv-impl", default=None)
    ap.add_argument("--sharding", default="tp",
                    choices=["tp", "fsdp"])
    ap.add_argument("--rwkv-chunk", type=int, default=None)
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    from .cells import CellOverrides, arch_shape_cells

    if args.list:
        for arch, shape, skip in arch_shape_cells():
            mark = f"SKIP ({skip})" if skip else "run"
            print(f"{arch:24s} {shape:12s} {mark}")
        return 0

    overrides = CellOverrides(
        remat=args.remat, loss_chunk=args.loss_chunk,
        compression=args.compression, expert_parallel=args.expert_parallel,
        zero=not args.no_zero, rwkv_impl=args.rwkv_impl,
        rwkv_chunk=args.rwkv_chunk, sharding=args.sharding,
        moe_dispatch=args.moe_dispatch,
        grad_accum=args.grad_accum)

    cells = []
    if args.all:
        cells = [(a, s, skip) for a, s, skip in arch_shape_cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all / --list)")
        cells = [(args.arch, args.shape, None)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    fake_group(512 if "multi" in meshes else 256)

    failures = 0
    for arch, shape, skip in cells:
        for mk in meshes:
            name = f"{arch}__{shape}__{mk}__{args.tag}"
            if skip:
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "skipped", "reason": skip}
                print(f"[skip] {name}: {skip}")
            else:
                print(f"[cell] {name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mk, overrides)
                    print(f"  ok: lower {rec['lower_s']}s  compile "
                          f"{rec['compile_s']}s  "
                          f"flops/dev {rec['flops_per_device']:.3e}  "
                          f"coll/dev {rec['collective_bytes']['total']:.3e}B  "
                          f"dominant {rec['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mk,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"  FAIL: {e}", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(f"{args.out}/{name}.json", "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
