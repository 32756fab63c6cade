"""bebopc-equivalent CLI (paper §6.1), copied from ``repro.core.cli``.

    python -m repro_torch.core.cli build schema.bop --python-out ./generated
    python -m repro_torch.core.cli build schema.bop --descriptor-out schema.bin
    python -m repro_torch.core.cli check schema.bop
    python -m repro_torch.core.cli ids schema.bop        # method routing IDs
"""
import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bebopc", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="compile a schema")
    b.add_argument("schema")
    b.add_argument("--python-out", default=None,
                   help="directory for the generated python module")
    b.add_argument("--descriptor-out", default=None,
                   help="path for the Bebop-encoded DescriptorSet")
    b.add_argument("-I", "--include", action="append", default=[])

    c = sub.add_parser("check", help="parse + validate only")
    c.add_argument("schema")
    c.add_argument("-I", "--include", action="append", default=[])

    i = sub.add_parser("ids", help="print service method routing IDs")
    i.add_argument("schema")
    i.add_argument("-I", "--include", action="append", default=[])

    args = ap.parse_args(argv)

    from .compiler import compile_file
    from .schema import ServiceDef

    try:
        schema = compile_file(args.schema, include_dirs=args.include)
    except Exception as e:  # noqa: BLE001 — CLI reports compile errors
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.cmd == "check":
        n = len(schema.definitions)
        print(f"{args.schema}: OK ({n} definitions)")
        return 0

    if args.cmd == "ids":
        for name, d in schema.definitions.items():
            if isinstance(d, ServiceDef):
                for m in d.methods:
                    print(f"{m.id:#010x}  /{d.name}/{m.name}  ({m.kind})")
        return 0

    # build
    if args.python_out:
        from .codegen import generate_python
        os.makedirs(args.python_out, exist_ok=True)
        base = os.path.splitext(os.path.basename(args.schema))[0]
        out = os.path.join(args.python_out, f"{base}_bebop.py")
        with open(out, "w") as f:
            f.write(generate_python(schema))
        print(f"wrote {out}")
    if args.descriptor_out:
        from .descriptor import encode_descriptor_set
        with open(args.descriptor_out, "wb") as f:
            f.write(encode_descriptor_set([schema]))
        print(f"wrote {args.descriptor_out}")
    if not args.python_out and not args.descriptor_out:
        print("nothing to do (pass --python-out / --descriptor-out)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
